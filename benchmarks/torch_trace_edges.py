"""How many kernel records a ``torch.profiler`` trace of serving-engine
ticks loses on the card, with the ticks at the trace's ends and with
``chip_smoke.cuda_trace``'s margins around them.

    PYTHONPATH=src python benchmarks/torch_trace_edges.py [--arch rwkv6-7b]
        [--waves 8]

Serves full-width ``--arch`` (random M8F8 weights, 2 adapters) on
``repro_torch``'s paged engine as ``chip_smoke.py`` does, one wave of 8
prompts of 256 tokens at a time: one wave by ``eng.step`` captures the
graphs, then ``--waves`` waves alternate between the eager step and graph
replay. Each wave is traced in windows, its first tick (every slot
prefills a chunk) and then 8 decode ticks at a time, and the windows
alternate between two ways of tracing: "bare" (the profiler entered just
before the ticks and left just after their synchronisation) and
"margins" (``cuda_trace``: a marker kernel and 50 ms idle after it
starts and before it stops).

Per window: "lost", the kernel-launch API records (cudaLaunchKernel and
the like; a graph replay's kernels have none) whose kernel record is
missing (as ``chip_smoke.lost_launches`` counts them), split by where
they stand (first or second half of the window's launches); whether the
port kernels in the trace equal the ``kernels.LAUNCHES`` delta; and
whether ``chip_smoke.traced_ticks``'s check would hold (exact where every
tick replayed a graph, elsewhere short by no more than the lost
launches). Each output line is one JSON object: the card's name and
power limit first, with ``--windows`` each window that lost a record
(where the first lost ones stand; each replay's records where port
kernels are missing), then one line per window kind.
"""
import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs                                   # noqa: E402


def bare_trace():
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    return profile(activities=[ProfilerActivity.CUDA])


def window(eng, n, tick, margins):
    """Trace ``n`` ticks by ``tick()``; count what the trace lost."""
    from torch.autograd import DeviceType

    from repro_torch import kernels

    before, replays, ran = dict(kernels.LAUNCHES), eng.replays, 0
    with (cs.cuda_trace() if margins else bare_trace()) as prof:
        for _ in range(n):
            if eng.queue or eng.sched.active():
                tick()
                ran += 1
        torch.cuda.synchronize()
    counts = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    ids = {e.id for e in kern}
    launches = sorted((e for e in events if e.device_type == DeviceType.CPU
                       and e.name in cs.LAUNCH_API),
                      key=lambda e: e.time_range.start)
    if margins:                  # the margins' marker kernels
        launches = launches[1:-1]
        kern = cs.device_events(prof)
    lost = [i for i, e in enumerate(launches) if e.id not in ids]
    # where each of the first lost ones stands: its index among the
    # window's launches, ms after the trace began, and the kernels
    # recorded just before and after it in launch (correlation) order
    by_id = sorted(kern, key=lambda e: e.id)
    at = []
    for i in lost[:4]:
        c = launches[i].id
        j = next((j for j, e in enumerate(by_id) if e.id > c), len(by_id))
        at.append([i, round(launches[i].time_range.start / 1e3, 3),
                   by_id[j - 1].name[:60] if j else None,
                   by_id[j].name[:60] if j < len(by_id) else None])
    traced, counted = cs.port_kernel_counts(kern, counts)
    half = len(launches) / 2
    short = sum(counted.values()) - sum(traced.values())
    replayed = eng.replays - replays == ran
    holds = short <= (0 if replayed else len(lost)) and all(
        traced[k] <= counted[k] for k in traced)
    return {"check_holds": holds, "launches": len(launches),
            "lost": len(lost),
            "lost_first_half": sum(1 for i in lost if i < half),
            "lost_second_half": sum(1 for i in lost if i >= half),
            "port_kernels_missing": short,
            "port_counts_equal": traced == counted, "lost_at": at,
            # each graph launch: ms after the trace began, the kernel
            # records carrying its correlation id, and port kernels among
            # them (where a window of replays came out short)
            "replays": None if traced == counted else [
                [round(g.time_range.start / 1e3, 3),
                 sum(1 for e in kern if e.id == g.id),
                 sum(1 for e in kern if e.id == g.id
                     and "(anonymous namespace)::" in e.name)]
                for g in events if g.device_type == DeviceType.CPU
                and "GraphLaunch" in g.name]}


def make_engine(cfg, dev):
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import lora as lora_lib
    from repro_torch.core import quant
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.api import make_engine as make

    g = torch.Generator(device=dev).manual_seed(0)
    params = quant.quantize_params(tfm.init_params(cfg, g, device=dev),
                                   QuantConfig(mha_bits=8, ff_bits=8))
    gc.collect()
    adapters = []
    for _ in range(2):
        ad = lora_lib.init_lora_params(cfg, g, device=dev)
        for entry in ad["layers"]:
            for ab in entry.values():
                ab["b"].normal_(0.0, 0.02, generator=g)
        adapters.append(ad)
    return make(cfg, params, adapters, mode="paged", device=dev,
                max_slots=8, max_len=1024, page_size=16, prefill_chunk=128,
                seed=0)


def wave(eng, cfg, tick, seed, tally=None, margins=False, verbose=False):
    """One wave of 8 prompts of 256; its windows traced (if ``tally``) in
    turns bare / margins, the first as ``margins`` says."""
    from repro_torch.serve.api import Request

    rng = np.random.default_rng(seed)
    for i in range(8):
        eng.submit(Request(uid=100_000 * (seed + 1) + i, prompt=rng.integers(
            0, cfg.vocab_size, 256).astype(np.int32), max_new_tokens=40,
            adapter_id=i % 2))
    first = True
    while eng.queue or eng.sched.active():
        if tally is None:
            tick()
            continue
        kind = "mixed" if first else "decode"
        r = window(eng, 1 if first else 8, tick, margins)
        if verbose and (r["lost"] or not r["port_counts_equal"]):
            print(json.dumps({"kind": kind, "margins": margins, **r}),
                  flush=True)
        first = False
        t = tally.setdefault((kind, margins), {
            "windows": 0, "windows_losing": 0, "launches": 0, "lost": 0,
            "lost_first_half": 0, "lost_second_half": 0,
            "port_kernels_missing": 0, "port_counts_unequal": 0,
            "check_fails": 0})
        t["windows"] += 1
        t["windows_losing"] += r["lost"] > 0
        t["port_counts_unequal"] += not r["port_counts_equal"]
        t["check_fails"] += not r["check_holds"]
        for k in ("launches", "lost", "lost_first_half", "lost_second_half",
                  "port_kernels_missing"):
            t[k] += r[k]
        margins = not margins


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--windows", action="store_true",
                    help="also print each window that lost a record")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    build.build()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    cfg = get_config(args.arch)
    eng = make_engine(cfg, dev)
    wave(eng, cfg, eng.step, seed=0)             # captures the graphs
    tally = {"eager": {}, "graph": {}}
    for w in range(args.waves):
        step = ("eager", "graph")[w % 2]
        tick = (eng.step if step == "graph"
                else lambda: eng._advance(eng._eager))
        wave(eng, cfg, tick, seed=1 + w, tally=tally[step],
             margins=bool(w // 2 % 2), verbose=args.windows)
    for step, kinds in tally.items():
        for (kind, margins), t in sorted(kinds.items()):
            print(json.dumps({"arch": args.arch, "step": step,
                              "window": kind, "margins": margins, **t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
