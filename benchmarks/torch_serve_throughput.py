"""Serving throughput on the port: paged arena + chunked prefill against
the dense ``max_batch x max_len`` baseline, at 16+ concurrent mixed-length
requests and 4 LoRA adapters hot (paper SS V.G multi-task serving), by
``benchmarks/bench_serve_throughput.py``'s protocol (its workloads 1, 2,
3, 5 and 6, with its sizes, traffic and seeds).

    PYTHONPATH=src:. python benchmarks/torch_serve_throughput.py [--device cpu]
    BENCH_SMOKE=1 PYTHONPATH=src:. python benchmarks/torch_serve_throughput.py

Runs on the CUDA card by default (the paged engine's mixed step and the
dense engine's decode step as CUDA graphs; the paged and contiguous flash
kernels; the base is not quantized, as in the JAX script) and on the CPU
given ``--device cpu``. ``BENCH_SMOKE=1`` takes the JAX script's smoke
sizes.

Workload 1: decode tokens/s (a second pass over each engine, so every
graph is captured before the measured pass), per-request p50/p99
completion latency, KV arena bytes, the dense engine's pass split into
its eager prefills and its decode steps (its speedup's baseline is this
port's dense engine, not the JAX package's), and the paged engine's graph
accounting: one captured graph per (chunk bucket, table bucket)
signature, never one per prompt length (the JAX script checks its jit
cache the same way). Workload 2: shared-prefix traffic (requests drawn
from 4 prompt families), prefix cache on against off: prefill tokens
computed, prefix-hit rate, peak KV pages, with the greedy tokens held to
the dense oracle's. Workload 3: the same shared-prefix traffic with
speculative decoding (``SpecConfig(k=4, drafter="ngram")``, the prefix
cache on): accept rate, decode tokens per verify step, wall speedup over
the spec-off run, the greedy tokens held to the dense oracle's. Workload
5: MoE dispatch on reduced llama4-scout (the base unquantized, as in the
JAX script), dropless (the serving default) against the capacity
baseline on traffic that makes capacity drop (prompts of 6-48 tokens in
chunks of 8): tokens/s of both, the capacity run's dropped assignments,
the dropless greedy tokens held to the dense oracle's. Workload 6:
speculative decoding on the Mamba+attention hybrid (reduced
jamba-1.5-large-398b, unquantized, n-gram drafter, motif-tiled prompts
that the drafter can follow): every rejected draft restores the slots'
Mamba state (``SlotStateArena``) and replays the accepted prefix; accept
rate, recurrent rollbacks, tokens/s with spec on and off, the greedy
tokens held to the dense oracle's. The JAX script's workload 4 (tensor
parallelism) waits for ROADMAP Queue 1 item 16 and prints one line saying
so. Writes ``experiments/paper/torch_serve_throughput.json`` with the JAX
script's payload keys for workloads 1, 2, 3, 5 and 6, and ``device``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from benchmarks.torch_common import emit, save_json
from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import lora as lora_lib
from repro_torch.models import kvcache
from repro_torch.models.transformer import init_params
from repro_torch.serve.api import Request
from repro_torch.serve.engine import DenseServeEngine, PagedServeEngine
from repro_torch.serve.spec import SpecConfig

# the JAX script's workloads that wait for a later slice of the port
WAITING = (("tensor_parallel", "tensor-parallel paged decode", 16),)


def _requests(n, vocab, rng, max_new):
    reqs = []
    for i in range(n):
        plen = int(rng.integers(6, 64))
        reqs.append(dict(uid=i,
                         prompt=rng.integers(0, vocab, plen).astype(np.int32),
                         max_new_tokens=max_new, adapter_id=i % 4))
    return reqs


def _family_requests(n, vocab, rng, max_new, families=4, head_len=48):
    """Shared-prefix traffic: every request's prompt starts with its
    family's common head (per-family adapter, so prefixes are shareable)."""
    heads = [rng.integers(0, vocab, head_len).astype(np.int32)
             for _ in range(families)]
    reqs = []
    for i in range(n):
        tail = rng.integers(0, vocab,
                            int(rng.integers(4, 12))).astype(np.int32)
        reqs.append(dict(uid=i,
                         prompt=np.concatenate([heads[i % families], tail]),
                         max_new_tokens=max_new, adapter_id=i % families))
    return reqs


def _page_bytes(cache, num_pages):
    """Bytes one pool page costs across every paged (kp/vp) leaf."""
    total = 0
    for entry in cache["layers"]:
        for name, leaf in entry.items():
            if name in ("kp", "vp"):
                total += leaf.numel() * leaf.element_size()
    return total // num_pages


def _drive(make_engine, reqs, warm_passes=1):
    """Warm + measure passes over ONE engine instance: warm passes capture
    every graph (greedy decode is deterministic, so the measured pass meets
    exactly the same signatures); the final pass measures wall time and
    per-request completion latency. Engines with the prefix cache on need
    warm_passes=2: the cache is empty on pass 1 and saturated from pass 2
    onward, so only pass 2 schedules the chunk shapes the measured pass
    meets."""
    eng = make_engine()

    def one_pass(uid_off):
        for r in reqs:
            eng.submit(Request(**{**r, "uid": r["uid"] + uid_off}))
        pf0 = getattr(eng, "prefill_s", 0.0)
        t0 = time.perf_counter()
        done_at = {}
        ticks = 0
        while (eng.queue or (eng.sched.active() if hasattr(eng, "sched")
                             else any(eng.slot_req))) and ticks < 100_000:
            eng.step()
            ticks += 1
            now = time.perf_counter() - t0
            for uid in eng.finished:
                if uid >= uid_off:
                    done_at.setdefault(uid, now)
        wall = time.perf_counter() - t0
        total_new = sum(len(r.generated) for u, r in eng.finished.items()
                        if u >= uid_off)
        lats = np.asarray([done_at[u] for u in sorted(done_at)])
        out = dict(wall_s=wall, ticks=ticks, new_tokens=total_new,
                   tok_per_s=total_new / wall,
                   p50_s=float(np.percentile(lats, 50)),
                   p99_s=float(np.percentile(lats, 99)))
        if isinstance(eng, DenseServeEngine):
            # its eager prefills (one a request) against the rest of its
            # ticks (the decode steps, a graph replay each on the card)
            pf = eng.prefill_s - pf0
            out.update(prefill_s=pf, decode_s=wall - pf,
                       decode_ms_per_tick=1e3 * (wall - pf) / ticks)
        return out

    for p in range(warm_passes):     # warm-up: captures every signature
        one_pass((p + 1) * 100_000)
    return eng, one_pass((warm_passes + 1) * 100_000)  # measured


def run(device=None):
    dev = resolve_device(device)
    smoke = os.environ.get("BENCH_SMOKE", "0") == "1"
    cfg = reduce_config(get_config("llama3.2-1b"))
    n_req, max_new = (16, 8) if smoke else (24, 24)
    max_len, max_slots, page = (256, 16, 16) if smoke else (1024, 16, 16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    adapters = [lora_lib.init_lora_params(
        cfg, torch.Generator(device=dev).manual_seed(i + 1), device=dev)
        for i in range(4)]
    rng = np.random.default_rng(0)
    reqs = _requests(n_req, cfg.vocab_size, rng, max_new)
    # pool sized for the mixed traffic, a fraction of the dense arena
    num_pages = max_slots * (64 + max_new + page) // page

    def dense_engine():
        return DenseServeEngine(cfg, params, adapters=adapters, device=dev,
                                max_batch=max_slots, max_len=max_len)

    def paged_engine(prefix_cache, spec=None):
        return lambda: PagedServeEngine(
            cfg, params, adapters=adapters, device=dev, max_slots=max_slots,
            max_len=max_len, page_size=page, num_pages=num_pages,
            prefill_chunk=32, enable_prefix_cache=prefix_cache, spec=spec)

    dense_eng, dense = _drive(dense_engine, reqs)
    # cache off here: this workload has no prompt overlap to exploit (the
    # prefix cache is measured on the shared-prefix workload below)
    paged_eng, paged = _drive(paged_engine(False), reqs)

    stats = paged_eng.stats().as_dict()
    speedup = paged["tok_per_s"] / dense["tok_per_s"]
    dense_bytes = kvcache.cache_bytes(dense_eng.cache)
    paged_bytes = kvcache.cache_bytes(paged_eng.cache)
    max_sigs = (len(paged_eng.chunk_buckets) * len(paged_eng.block_buckets))
    assert len(stats["step_signatures"]) <= max_sigs, (
        stats["step_signatures"], max_sigs)
    # one captured graph per signature on the card (the CPU runs eagerly)
    graphs = len(stats["step_signatures"]) if dev.type == "cuda" else 0
    assert stats["compiled_steps"] == graphs, stats
    dense_graphs = dense_eng.stats().compile.compiled_steps
    assert dense_graphs == int(dev.type == "cuda"), dense_graphs
    # both engines give every request the same greedy tokens (a check the
    # JAX script makes on the shared-prefix workload only)
    paged_identical = all(
        paged_eng.finished[u].generated == dense_eng.finished[u].generated
        for u in paged_eng.finished)
    assert paged_identical, "paged decode diverged from the dense oracle"

    # ---- shared-prefix workload: prefix cache ON vs OFF, dense oracle for
    # greedy equivalence
    srng = np.random.default_rng(1)
    sreqs = _family_requests(n_req, cfg.vocab_size, srng, max_new,
                             families=4)
    nocache_eng, nocache = _drive(paged_engine(False), sreqs)
    shared_eng, shared = _drive(paged_engine(True), sreqs, warm_passes=2)
    oracle_eng, _ = _drive(dense_engine, sreqs)
    # uids are offset per pass; greedy decode is deterministic, so every
    # pass of either engine must produce the base request's tokens
    identical = all(
        shared_eng.finished[u].generated
        == oracle_eng.finished[100_000 + u % 100_000].generated
        for u in shared_eng.finished)
    assert identical, "prefix-shared paged decode diverged from dense oracle"

    # ---- spec-decode workload: the same shared-prefix traffic, n-gram
    # drafter on against off (both with the prefix cache), dense oracle
    spec_eng, spec = _drive(
        paged_engine(True, SpecConfig(k=4, drafter="ngram")), sreqs,
        warm_passes=2)
    spec_identical = all(
        spec_eng.finished[u].generated
        == oracle_eng.finished[100_000 + u % 100_000].generated
        for u in spec_eng.finished)
    assert spec_identical, "spec-on greedy decode diverged from dense oracle"
    sp = spec_eng.stats().as_dict()
    spec_sigs = len(sp["step_signatures"]) if dev.type == "cuda" else 0
    assert sp["compiled_steps"] == spec_sigs, sp
    spec_speedup = spec["tok_per_s"] / max(shared["tok_per_s"], 1e-9)
    # every verify step emits accepted_in_row + 1 tokens, so the verify
    # steps number decode_tokens - accepted_tokens: the step compression
    # that verification buys
    tokens_per_step = (sp["decode_tokens"]
                       / max(sp["decode_tokens"] - sp["accepted_tokens"], 1))

    # ---- MoE workload: dropless (serving default) vs capacity dispatch on
    # a reduced llama4-scout, dense oracle for greedy equivalence. Prompt
    # widths 6..48 under prefill_chunk=8 land real capacity drops at the
    # default capacity_factor (1.25): C = ceil(8*1.25/4) = 3 rows for an
    # 8-wide top-1 chunk over 4 reduced experts.
    mcfg = reduce_config(get_config("llama4-scout-17b-a16e"))
    mparams = init_params(mcfg, torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    mrng = np.random.default_rng(2)
    m_req, m_new = (6, 6) if smoke else (12, 10)
    mreqs = [dict(uid=i,
                  prompt=mrng.integers(1, mcfg.vocab_size,
                                       int(mrng.integers(6, 48)))
                  .astype(np.int32),
                  max_new_tokens=m_new) for i in range(m_req)]
    moe_kw = dict(device=dev, max_slots=8, max_len=128, page_size=8,
                  prefill_chunk=8, enable_prefix_cache=False)
    dropless_eng, dropless = _drive(
        lambda: PagedServeEngine(mcfg, mparams, **moe_kw), mreqs)
    capacity_eng, capacity = _drive(
        lambda: PagedServeEngine(mcfg, mparams, moe_dispatch="capacity",
                                 **moe_kw), mreqs)
    moracle_eng, _ = _drive(
        lambda: DenseServeEngine(mcfg, mparams, device=dev, max_batch=8,
                                 max_len=128), mreqs)
    moe_dl = dropless_eng.stats()
    moe_cap = capacity_eng.stats()
    assert moe_dl.moe.dropped_tokens == 0, \
        "dropless serving dropped MoE tokens"
    moe_identical = all(
        dropless_eng.finished[u].generated
        == moracle_eng.finished[100_000 + u % 100_000].generated
        for u in dropless_eng.finished)
    assert moe_identical, "dropless MoE decode diverged from dense oracle"

    # ---- spec-on-hybrid workload: speculative decoding on the Mamba +
    # attention hybrid. Every rejected draft goes through the
    # SlotStateArena checkpoint / restore and the recurrent rollback and
    # replay, so greedy equivalence with the dense engine is the bar.
    hcfg = reduce_config(get_config("jamba-1.5-large-398b"))
    hparams = init_params(hcfg, torch.Generator(device=dev).manual_seed(2),
                          device=dev)
    hrng = np.random.default_rng(3)
    h_req, h_new = (5, 10) if smoke else (10, 16)
    # motif-tiled prompts: repetitive enough that the n-gram drafter gets
    # real acceptances, so both accept and reject paths are measured
    hreqs = []
    for i in range(h_req):
        motif = hrng.integers(1, hcfg.vocab_size, 3).astype(np.int32)
        hreqs.append(dict(uid=i,
                          prompt=np.tile(motif, int(hrng.integers(3, 8))),
                          max_new_tokens=h_new))
    hyb_kw = dict(device=dev, max_slots=4, max_len=64, page_size=8,
                  prefill_chunk=8)
    hyb_off_eng, hyb_off = _drive(
        lambda: PagedServeEngine(hcfg, hparams, **hyb_kw), hreqs)
    hyb_on_eng, hyb_on = _drive(
        lambda: PagedServeEngine(hcfg, hparams,
                                 spec=SpecConfig(k=4, drafter="ngram"),
                                 **hyb_kw), hreqs)
    horacle_eng, _ = _drive(
        lambda: DenseServeEngine(hcfg, hparams, device=dev, max_batch=4,
                                 max_len=64), hreqs)
    hst = hyb_on_eng.stats()
    assert hst.spec.enabled and hst.spec.disabled_reason is None
    hsd = hst.as_dict()
    hyb_identical = all(
        hyb_on_eng.finished[u].generated
        == horacle_eng.finished[100_000 + u % 100_000].generated
        for u in hyb_on_eng.finished)
    assert hyb_identical, "spec-on hybrid decode diverged from dense oracle"

    ns, ss = nocache_eng.stats().as_dict(), shared_eng.stats().as_dict()
    pb = _page_bytes(shared_eng.cache, num_pages)
    # counters accumulate over every pass (nocache ran 2, shared ran 3);
    # compare per-pass averages: the shared average still includes its
    # cold first pass, so this understates the steady-state reduction
    prefill_reduction = (ns["prefill_tokens"] / 2) / max(
        ss["prefill_tokens"] / 3, 1)
    hit_rate = ss["prefix_hit_tokens"] / max(
        ss["prefix_hit_tokens"] + ss["prefill_tokens"], 1)
    kv_peak_nocache = ns["peak_pages"] * pb
    kv_peak_shared = ss["peak_pages"] * pb

    emit("torch_serve_dense",
         dense["wall_s"] * 1e6 / max(dense["ticks"], 1),
         f"tok/s={dense['tok_per_s']:.1f}_p99={dense['p99_s']*1e3:.0f}ms")
    emit("torch_serve_paged",
         paged["wall_s"] * 1e6 / max(paged["ticks"], 1),
         f"tok/s={paged['tok_per_s']:.1f}_p99={paged['p99_s']*1e3:.0f}ms")
    emit("torch_serve_dense_split", 0.0,
         f"prefill={dense['prefill_s']*1e3:.1f}ms_"
         f"decode={dense['decode_s']*1e3:.1f}ms")
    emit("torch_serve_speedup", 0.0,
         f"{speedup:.2f}x_decode_throughput_over_the_port's_dense_oracle_"
         f"{'PASS' if speedup >= 2 else 'BELOW'}_2x_target_"
         f"kv_bytes_{dense_bytes/max(paged_bytes,1):.1f}x_smaller")
    emit("torch_serve_prefix_cache", 0.0,
         f"prefill_reduction_{prefill_reduction:.2f}x_"
         f"{'PASS' if prefill_reduction >= 2 else 'BELOW'}_2x_target_"
         f"hit_rate_{hit_rate:.2f}_"
         f"kv_peak_{kv_peak_nocache/max(kv_peak_shared,1):.2f}x_smaller")
    emit("torch_serve_spec_decode", 0.0,
         f"accept_rate_{sp['spec_accept_rate']:.2f}_"
         f"tokens_per_decode_step_{tokens_per_step:.2f}_"
         f"wall_speedup_{spec_speedup:.2f}x_"
         f"oracle_{'PASS' if spec_identical else 'DIVERGED'}")
    emit("torch_serve_moe_dropless", 0.0,
         f"dropless_tok/s={dropless['tok_per_s']:.1f}_"
         f"capacity_tok/s={capacity['tok_per_s']:.1f}_"
         f"dropped_0_vs_{moe_cap.moe.dropped_tokens}_"
         f"oracle_{'PASS' if moe_identical else 'DIVERGED'}")
    emit("torch_serve_spec_hybrid", 0.0,
         f"accept_rate_{hsd['spec_accept_rate']:.2f}_"
         f"recurrent_rollbacks_{hsd['spec_recurrent_rollbacks']}_"
         f"tok/s_on_{hyb_on['tok_per_s']:.1f}_off_{hyb_off['tok_per_s']:.1f}_"
         f"oracle_{'PASS' if hyb_identical else 'DIVERGED'}")
    for key, what, item in WAITING:
        print(f"torch_serve_{key}: not run: {what} waits for ROADMAP "
              f"Queue 1 item {item}")

    payload = {
        "smoke": smoke,
        "device": str(dev),
        "workload": {"n_requests": n_req, "adapters": 4,
                     "prompt_lens": "6..64 mixed", "max_new": max_new,
                     "max_len": max_len, "max_slots": max_slots},
        "dense": {**dense, "kv_bytes": dense_bytes,
                  "decode_graphs": dense_graphs},
        "paged": {**paged, "kv_bytes": paged_bytes,
                  "page_size": page, "num_pages": num_pages,
                  "compiled_steps": stats["compiled_steps"],
                  "step_signatures": [list(s) for s in
                                      stats["step_signatures"]],
                  "max_signatures": max_sigs,
                  "greedy_matches_dense_oracle": bool(paged_identical),
                  "preemptions": stats["preemptions"],
                  "peak_pages": stats["peak_pages"]},
        "decode_throughput_speedup": speedup,
        "meets_2x_target": bool(speedup >= 2),
        # the speedup's baseline is this port's dense engine on the same
        # device (eager prefills, see ``dense``), not the JAX package's
        "speedup_baseline": "DenseServeEngine of the port, same device",
        "shared_prefix": {
            "workload": {"n_requests": n_req, "families": 4,
                         "head_len": 48, "tail_lens": "4..12"},
            "nocache": {**nocache,
                        "prefill_tokens": ns["prefill_tokens"],
                        "peak_pages": ns["peak_pages"],
                        "kv_peak_bytes": kv_peak_nocache},
            "prefix_cache": {**shared,
                             "prefill_tokens": ss["prefill_tokens"],
                             "prefix_hit_tokens": ss["prefix_hit_tokens"],
                             "prefix_hits": ss["prefix_hits"],
                             "cow_forks": ss["cow_forks"],
                             "shared_pages": ss["shared_pages"],
                             "index_pages": ss.get("index_pages", 0),
                             "peak_pages": ss["peak_pages"],
                             "kv_peak_bytes": kv_peak_shared},
            "prefill_token_reduction": prefill_reduction,
            "prefix_hit_rate": hit_rate,
            "meets_2x_prefill_reduction": bool(prefill_reduction >= 2),
            "greedy_matches_dense_oracle": bool(identical),
        },
        "spec_decode": {
            "drafter": "ngram", "k": 4,
            "spec_on": {**spec,
                        "spec_steps": sp["spec_steps"],
                        "drafted_tokens": sp["drafted_tokens"],
                        "accepted_tokens": sp["accepted_tokens"],
                        "rolled_back_tokens": sp["rolled_back_tokens"],
                        "rolled_back_pages": sp["rolled_back_pages"],
                        "compiled_steps": sp["compiled_steps"]},
            "spec_off_tok_per_s": shared["tok_per_s"],
            "accept_rate": sp["spec_accept_rate"],
            "tokens_per_decode_step": tokens_per_step,
            "decode_throughput_speedup": spec_speedup,
            "greedy_matches_dense_oracle": bool(spec_identical),
        },
        "moe_dropless": {
            "arch": "llama4-scout-17b-a16e (reduced)",
            "workload": {"n_requests": m_req, "prompt_lens": "6..48",
                         "max_new": m_new, "prefill_chunk": 8},
            "dropless": {**dropless,
                         "dropped_tokens": moe_dl.moe.dropped_tokens},
            "capacity": {**capacity,
                         "dropped_tokens": moe_cap.moe.dropped_tokens},
            "dropless_over_capacity_tok_per_s":
                dropless["tok_per_s"] / max(capacity["tok_per_s"], 1e-9),
            "capacity_dropped_tokens": moe_cap.moe.dropped_tokens,
            "greedy_matches_dense_oracle": bool(moe_identical),
        },
        "spec_hybrid": {
            "arch": "jamba-1.5-large-398b (reduced)",
            "drafter": "ngram", "k": 4,
            "workload": {"n_requests": h_req, "prompt_lens": "9..21",
                         "max_new": h_new, "prefill_chunk": 8},
            "spec_on": {**hyb_on,
                        "drafted_tokens": hsd["drafted_tokens"],
                        "accepted_tokens": hsd["accepted_tokens"],
                        "rolled_back_tokens": hsd["rolled_back_tokens"],
                        "recurrent_rollbacks":
                            hsd["spec_recurrent_rollbacks"]},
            "spec_off_tok_per_s": hyb_off["tok_per_s"],
            "accept_rate": hsd["spec_accept_rate"],
            "greedy_matches_dense_oracle": bool(hyb_identical),
        },
        "waiting": {key: f"ROADMAP Queue 1 item {item}"
                    for key, _, item in WAITING},
    }
    save_json("torch_serve_throughput", payload)
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    run(ap.parse_args().device)
