"""Paper Table II on the port: the FLOP counts of the attention block and
the MLP of reduced ``paper-gpt2-medium``, tallied as ``repro_torch`` runs
them, against the analytic O(.) terms. The tally must match the closed
forms per kernel class, as in ``benchmarks/bench_kernel_complexity.py``.

    PYTHONPATH=src:. python benchmarks/torch_kernel_complexity.py [--device cpu]

Runs on the CUDA card by default (the flash kernel for MHA-2/3) and on the
CPU, with the kernels' plain versions, given ``--device cpu``. The port
counts when the code runs, so the block runs for real. Its attention has
no train mode yet (ROADMAP Queue 1 item 15), so the block runs in prefill
mode over a cache of ``n`` positions: the same products. Writes
``experiments/paper/torch_tableII_complexity.json``.
"""
import argparse

import torch

from benchmarks.common import emit, save_json
from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import hetero
from repro_torch.models import attention as attn_mod, layers


def run(device=None):
    dev = resolve_device(device)
    cfg = reduce_config(get_config("paper-gpt2-medium"), d_model=128,
                        n_heads=4, d_ff=512)
    d, ff, n, B = cfg.d_model, cfg.d_ff, 64, 2
    g = torch.Generator(device=dev).manual_seed(0)
    kw = dict(device=dev, dtype=torch.float32)
    p_attn = attn_mod.init_attn(cfg, g, **kw)
    p_mlp = layers.init_mlp(cfg, g, **kw)
    x = torch.randn((B, n, d), generator=g, **kw)
    pos = torch.arange(n, device=dev, dtype=torch.int32)[None].expand(B, n)

    payload = {"device": str(dev)}
    # MHA-1..4 (static) + MHA-2/3 (dynamic)
    with hetero.tally() as t:
        attn_mod.apply_attention_block(cfg, p_attn, x, pos, kind="full",
                                       mode="prefill", prefill_cache_len=n)
    static_expected = 2 * B * n * (d * cfg.q_dim + 2 * d * cfg.kv_dim
                                   + cfg.q_dim * d)     # MHA-1 + MHA-4
    dyn_expected = 2 * 2 * B * n * n * cfg.q_dim        # MHA-2 + MHA-3
    payload["mha"] = {"static": t[hetero.STATIC],
                      "static_expected": static_expected,
                      "dynamic": t[hetero.DYNAMIC],
                      "dynamic_expected": dyn_expected}
    emit("tableII_mha_static", 0.0,
         f"meas={t[hetero.STATIC]:.3g}_analytic={static_expected:.3g}")
    emit("tableII_mha_dynamic", 0.0,
         f"meas={t[hetero.DYNAMIC]:.3g}_analytic={dyn_expected:.3g}")
    assert abs(t[hetero.STATIC] - static_expected) / static_expected < 1e-6
    assert abs(t[hetero.DYNAMIC] - dyn_expected) / dyn_expected < 1e-6

    # FF-1/FF-2
    with hetero.tally() as t:
        layers.apply_mlp(cfg, p_mlp, x)
    n_mats = 3 if cfg.mlp.startswith("gated") else 2
    ff_expected = 2 * B * n * d * ff * n_mats
    payload["ff"] = {"static": t[hetero.STATIC], "expected": ff_expected}
    emit("tableII_ff", 0.0,
         f"meas={t[hetero.STATIC]:.3g}_analytic={ff_expected:.3g}")
    assert abs(t[hetero.STATIC] - ff_expected) / ff_expected < 1e-6
    save_json("torch_tableII_complexity", payload)
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    run(ap.parse_args().device)
