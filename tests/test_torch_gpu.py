"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``gpu`` and skips without a CUDA device (the kernels
have no CPU mode). This file imports no JAX, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: crossbar 1e-4 relative (max-scaled absolute), as for the
Pallas kernel — the plain version dequantizes before one product, the
kernel scales each 128-deep f32 partial sum; flash 2e-5, f32 softmax
attention summed in another order.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import quant
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False   # f32 reference products

CB_SHAPES = [(32, 128, 128), (64, 256, 384), (100, 300, 130), (8, 520, 250),
             (1024, 2048, 512), (8, 8192, 2048)]
FA_SWEEP = [(2, 64, 64, 4, 2, 16), (1, 32, 96, 4, 4, 8), (2, 64, 64, 8, 2, 32),
            (1, 1, 64, 4, 2, 16), (1, 48, 48, 6, 3, 64)]
FA_FLAGS = [(None, None), (16, None), (None, 20.0)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mkn", CB_SHAPES)
def test_crossbar_kernel_matches_plain(bits, mkn):
    dev = _cuda_or_skip()
    M, K, N = mkn
    g = torch.Generator(device=dev).manual_seed(M + K + N + bits)
    w = torch.randn(K, N, generator=g, device=dev) * 0.1
    x = torch.randn(M, K, generator=g, device=dev)
    qt = quant.quantize(w, bits)
    before = kernels.LAUNCHES["crossbar_matmul"]
    y = cb_ops.crossbar_matmul(x, qt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crossbar_matmul"] == before + 1
    yr = cb_ops.crossbar_matmul_plain(x, qt)
    torch.testing.assert_close(y, yr, rtol=1e-4,
                               atol=1e-4 * float(yr.abs().max()))


@pytest.mark.gpu
def test_crossbar_kernel_refuses_what_it_does_not_take():
    dev = _cuda_or_skip()
    qt = quant.quantize(torch.randn(256, 128, device=dev), 8)
    with pytest.raises(TypeError):
        cb_ops.crossbar_matmul(torch.randn(4, 256, device=dev,
                                           dtype=torch.bfloat16), qt)
    with pytest.raises(ValueError):
        cb_ops.crossbar_matmul(torch.randn(256, 4, device=dev).T, qt)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D", FA_SWEEP)
@pytest.mark.parametrize("window,softcap", FA_FLAGS)
def test_flash_kernel_matches_plain(B, T, S, Hq, Hkv, D, window, softcap):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(T * S + D)
    q = torch.randn(B, T, Hq, D, generator=g, device=dev)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    qpos = torch.arange(S - T, S, dtype=torch.int32, device=dev)
    qpos = qpos[None].expand(B, T).contiguous()
    kpos = torch.arange(S, dtype=torch.int32, device=dev)
    kpos = torch.where(kpos % 7 == 3, -1, kpos)[None].expand(B, S).contiguous()
    o = fa_ops.flash_attention(q, k, v, qpos, kpos, window=window,
                               softcap=softcap)
    torch.cuda.synchronize()
    o_plain = fa_ops.flash_attention_plain(q, k, v, qpos, kpos, window=window,
                                           softcap=softcap)
    torch.testing.assert_close(o, o_plain, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_kernel_matches_plain(seed):
    """Block tables with -1 holes, ragged chunk_lens, one idle slot."""
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(seed)
    B, T, Hq, Hkv, D, page, nb, P = 4, 8, 4, 1, 16, 4, 5, 24
    kp = torch.randn(P, Hkv, page, D, generator=g, device=dev)
    vp = torch.randn(P, Hkv, page, D, generator=g, device=dev)
    q = torch.randn(B, T, Hq, D, generator=g, device=dev)
    lens = torch.tensor([0, 5, 9, 0], dtype=torch.int32, device=dev)
    clens = torch.tensor([8, 1, 6, 0], dtype=torch.int32, device=dev)
    perm = torch.randperm(P, generator=g, device=dev)[:B * nb]
    need = (lens + clens + page - 1) // page
    bt = torch.where(torch.arange(nb, device=dev)[None] < need[:, None],
                     perm.reshape(B, nb), -1).to(torch.int32)
    bt[2, 0] = -1
    pos = (lens[:, None] + torch.arange(T, device=dev)[None]).to(torch.int32)
    o = fa_ops.paged_flash_attention(q, kp, vp, pos, bt, lens, clens,
                                     page_size=page)
    torch.cuda.synchronize()
    o_plain = fa_ops.paged_flash_attention_plain(q, kp, vp, pos, bt, lens,
                                                 clens, page_size=page)
    torch.testing.assert_close(o, o_plain, rtol=2e-5, atol=2e-5)
