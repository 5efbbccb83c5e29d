"""Kernel microbenchmarks of the port: each CUDA kernel against its plain
PyTorch version, parity and time per call, at the shapes of
``benchmarks/bench_kernels.py`` (crossbar int8 and int4 (64, 512) x (512,
256); flash B 2, T 128, 4/2 heads, D 32, causal; wkv (1, 128, 4, 32)),
and the three backward kernels on the same inputs: ``crossbar_matmul_t``,
``flash_attention_bwd`` and ``rwkv6_wkv_bwd``.

    PYTHONPATH=src:. python benchmarks/torch_kernels.py [--device cpu]

On the CUDA card by default: ``us`` is the kernel wrapper's host time per
call, the card synchronised after each (these shapes are launch-bound;
``chip_smoke.py`` gives device times at the main path's shapes), ``err``
the largest absolute difference to the plain version. Given ``--device
cpu`` the wrappers run their plain versions, so ``err`` is 0 by
construction and ``us`` is a CPU time. Writes
``experiments/paper/torch_kernel_micro.json``.
"""
import argparse

import torch

from benchmarks.torch_common import emit, save_json, timed
from repro_torch import resolve_device
from repro_torch.core.quant import quantize
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops


def _err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def _case(payload, name, call, plain):
    out, us = timed(call)
    ref, plain_us = timed(plain, n=1)
    err = _err(out, ref)
    payload[name] = {"us": us, "err": err, "plain_us": plain_us}
    emit(f"kernel_{name}", us, f"err={err:.2e}")


def run(device=None):
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    payload = {"device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")}
    # crossbar matmul and its dx
    w = randn(512, 256, scale=0.1)
    x = randn(64, 512)
    gy = randn(64, 256)
    for bits in (8, 4):
        qt = quantize(w, bits)
        _case(payload, f"crossbar_int{bits}",
              lambda: cb_ops.crossbar_matmul(x, qt),
              lambda: cb_ops.crossbar_matmul_plain(x, qt))
        _case(payload, f"crossbar_t_int{bits}",
              lambda: cb_ops.crossbar_matmul_t(gy, qt),
              lambda: cb_ops.crossbar_matmul_t_plain(gy, qt))

    # flash attention, causal, and its backward from the plain forward
    q, dout = randn(2, 128, 4, 32), randn(2, 128, 4, 32)
    k, v = randn(2, 128, 2, 32), randn(2, 128, 2, 32)
    pos = torch.arange(128, device=dev, dtype=torch.int32)[None].expand(
        2, 128).contiguous()
    _case(payload, "flash_attention",
          lambda: fa_ops.flash_attention(q, k, v, pos, pos),
          lambda: fa_ops.flash_attention_plain(q, k, v, pos, pos))
    out, lse = fa_ops.flash_attention_plain(q, k, v, pos, pos, with_lse=True)
    _case(payload, "flash_attention_bwd",
          lambda: fa_ops.flash_attention_bwd(q, k, v, pos, pos, out, lse,
                                             dout),
          lambda: fa_ops.flash_attention_bwd_plain(q, k, v, pos, pos, out,
                                                   lse, dout))

    # rwkv wkv and its backward
    r, kk, vv = randn(1, 128, 4, 32), randn(1, 128, 4, 32), randn(1, 128, 4,
                                                                  32)
    ww = torch.sigmoid(randn(1, 128, 4, 32))
    u = randn(4, 32, scale=0.3)
    s0 = torch.zeros(1, 4, 32, 32, device=dev)
    dy, ds = randn(1, 128, 4, 32), randn(1, 4, 32, 32)
    args = (r, kk, vv, ww, u, s0)
    _case(payload, "rwkv6_wkv", lambda: wkv_ops.rwkv6_wkv(*args),
          lambda: wkv_ops.rwkv6_wkv_plain(*args))
    _case(payload, "rwkv6_wkv_bwd",
          lambda: wkv_ops.rwkv6_wkv_bwd(*args, dy, ds),
          lambda: wkv_ops.rwkv6_wkv_bwd_plain(*args, dy, ds))
    save_json("torch_kernel_micro", payload)
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    run(ap.parse_args().device)
