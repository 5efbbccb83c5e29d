"""The port's CUDA kernels against their plain PyTorch versions, and the
serving engine's CUDA-graph step against its eager step, on the card.

Every test is marked ``gpu`` and skips without a CUDA device (the kernels
have no CPU mode). This file imports no JAX, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: crossbar (and its grouped entry point) 1e-4 relative
(max-scaled absolute), as for the Pallas kernel — the plain version
dequantizes before one product, the kernel scales each 128-deep f32
partial sum and carries x as two bf16
pieces (|x - hi - lo| <= 2^-16 |x|); flash 2e-5, f32 softmax
attention summed in another order (the kernel's products in 3xTF32); wkv
1e-5 (rtol and atol), as for the Pallas kernel: the same f32 recurrence,
its sums in another order (the chunked kernel's products in 3xTF32);
selective scan 1e-5 of max |y| and of max |h_final|: the same f32
recurrence as its plain version, with fused multiply-adds and each
channel's dot product with C summed in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import lora as lora_lib
from repro_torch.core import quant
from repro_torch.core.noise import NoiseConfig
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import kvcache, ssm
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.serve.api import Request, make_engine
from repro_torch.train import steps

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False   # f32 reference products

CB_SHAPES = [(32, 128, 128), (64, 256, 384), (100, 300, 130), (8, 520, 250),
             (1024, 2048, 512), (8, 8192, 2048),
             # decode rows around the crossover at a main-path K
             (1, 4096, 512), (16, 4096, 512), (33, 4096, 512),
             (128, 4096, 512),
             # rwkv6-7b's deepest decode shape and widest prefill shape
             (8, 14336, 4096), (1024, 4096, 14336),
             # the paper models' (GPT-2-medium, BLOOM-560m) matrices
             (8, 1024, 1024), (8, 1024, 4096), (8, 4096, 1024),
             (1024, 1024, 1024), (1024, 1024, 4096), (1024, 4096, 1024),
             # the Fig. 13 fine-tunes' matrices (d 128, d_ff 512) at their
             # 16 x 64 rows
             (1024, 128, 128), (1024, 128, 512), (1024, 512, 128)]
FA_SWEEP = [(2, 64, 64, 4, 2, 16), (1, 32, 96, 4, 4, 8), (2, 64, 64, 8, 2, 32),
            (1, 1, 64, 4, 2, 16), (1, 48, 48, 6, 3, 64),
            # several row and key tiles with ragged edges, G = 4 and 8
            (2, 300, 300, 8, 2, 64), (1, 300, 300, 8, 1, 64),
            # decode rows split over the context (split-KV)
            (8, 1, 1000, 32, 8, 64),
            # the paper models' 16/16 heads (a group of 1): the forward's
            # 512-token prompt, and 8 decode rows
            (1, 512, 512, 16, 16, 64), (8, 1, 1024, 16, 16, 64),
            # head_dim 128 (32/8 heads) and 256 (gemma2's 16/8): ragged
            # prefill tiles, decode split over the context
            (1, 100, 300, 32, 8, 128), (4, 1, 700, 32, 8, 128),
            (1, 200, 200, 16, 8, 256), (8, 1, 600, 16, 8, 256)]
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


def _crossbar_inputs(dev, M, K, N, bits, seed, spread=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(K, N, generator=g, device=dev) * K ** -0.5
    x = torch.randn(M, K, generator=g, device=dev)
    if spread:              # rows over six decades, as outlier activations
        x *= 10.0 ** (6 * torch.rand(M, 1, generator=g, device=dev) - 3)
    return x, quant.quantize(w, bits)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("mkn", [(8, 4096, 512), (100, 300, 130),
                                 (128, 2048, 384)])
def test_crossbar_both_kernels_match_plain_at_any_m(kernel, mkn):
    """Either kernel forced at any M (the crossover is a speed choice)."""
    dev = _cuda_or_skip()
    for bits in (8, 4):
        x, qt = _crossbar_inputs(dev, *mkn, bits, sum(mkn) + bits)
        y = cb_ops.crossbar_matmul(x, qt, kernel=kernel)
        torch.cuda.synchronize()
        yr = cb_ops.crossbar_matmul_plain(x, qt)
        torch.testing.assert_close(y, yr, rtol=1e-4,
                                   atol=1e-4 * float(yr.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", [(8, 14336, 4096), (8, 8192, 2048),
                                 (1024, 4096, 4096), (1024, 2048, 512)])
def test_crossbar_kernel_is_deterministic(mkn):
    """The split-K reductions (decode; prefill on a narrow N) sum in a
    fixed order: two calls on the same inputs give the same bits."""
    dev = _cuda_or_skip()
    x, qt = _crossbar_inputs(dev, *mkn, 8, 11)
    y1 = cb_ops.crossbar_matmul(x, qt)
    y2 = cb_ops.crossbar_matmul(x, qt)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mkn", [(8, 14336, 512), (1024, 4096, 512)])
def test_crossbar_kernel_wide_range_x(bits, mkn):
    """Activation rows spread over six decades stay within 1e-4 * max|y|:
    the two bf16 pieces of x keep its f32 accuracy."""
    dev = _cuda_or_skip()
    x, qt = _crossbar_inputs(dev, *mkn, bits, 5 + bits, spread=True)
    y = cb_ops.crossbar_matmul(x, qt)
    torch.cuda.synchronize()
    yr = cb_ops.crossbar_matmul_plain(x, qt)
    assert float((y - yr).abs().max()) <= 1e-4 * float(yr.abs().max())


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


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", FA_FLAGS)
def test_flash_kernel_reads_positions_not_order(window, softcap):
    """kv_pos a permutation with -1 holes and q_pos out of order: tile
    skipping must decide from the positions loaded, not from key order."""
    dev = _cuda_or_skip()
    B, T, S, Hq, Hkv, D = 2, 70, 260, 8, 2, 64
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(B, T, Hq, D, generator=g, device=dev)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    kpos = torch.stack([torch.randperm(S, generator=g, device=dev)
                        for _ in range(B)]).to(torch.int32)
    kpos = torch.where(torch.rand(B, S, generator=g, device=dev) < 0.2, -1,
                       kpos).contiguous()
    qpos = torch.randint(0, S, (B, T), generator=g, device=dev,
                         dtype=torch.int32)
    qpos[0, :8] = -1                          # rows that see no key
    o = fa_ops.flash_attention(q, k, v, qpos, kpos, window=window,
                               softcap=softcap)
    torch.cuda.synchronize()
    o_plain = fa_ops.flash_attention_plain(q, k, v, qpos, kpos, window=window,
                                           softcap=softcap)
    torch.testing.assert_close(o, o_plain, rtol=2e-5, atol=2e-5)
    assert torch.all(o[0, :8] == 0.0)


def _paged_decode_inputs(dev, seed, B=8, Hq=32, Hkv=8, D=64, page=16,
                         nb=64, P=600):
    """The engine's decode shape: one query row per slot, contexts of
    64-544 keys, -1 holes in the tables and one page shared by two rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(63, 544, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    clens = torch.ones(B, dtype=torch.int32, device=dev)
    clens[B - 1] = 0                          # an idle slot
    need = (lens + clens + page - 1) // page
    perm = torch.randperm(P, generator=g, device=dev)[:B * nb].reshape(B, nb)
    bt = torch.where(torch.arange(nb, device=dev)[None] < need[:, None],
                     perm, -1).to(torch.int32)
    bt[0, 1] = -1                             # a hole inside the context
    bt[1, 0] = bt[2, 0]                       # a prefix page shared
    kp = torch.randn(P, Hkv, page, D, generator=g, device=dev)
    vp = torch.randn(P, Hkv, page, D, generator=g, device=dev)
    q = torch.randn(B, 1, Hq, D, generator=g, device=dev)
    pos = lens[:, None].contiguous()
    return q, kp, vp, pos, bt, lens, clens


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_kernel_matches_plain_at_d256(seed):
    """gemma2's paged decode (16/8 heads of 256, softcap 50) and a mixed
    chunk over the same pool."""
    dev = _cuda_or_skip()
    q, kp, vp, pos, bt, lens, clens = _paged_decode_inputs(
        dev, seed, Hq=16, Hkv=8, D=256)
    g = torch.Generator(device=dev).manual_seed(seed)
    C = 24
    qc = torch.randn(q.shape[0], C, 16, 256, generator=g, device=dev)
    cl = torch.tensor([24, 7, 0, 24, 1, 13, 24, 0], dtype=torch.int32,
                      device=dev)
    lc = torch.clamp(lens - 24, min=0).contiguous()
    pc = (lc[:, None] + torch.arange(C, device=dev)[None]).to(torch.int32)
    for args in ((q, kp, vp, pos, bt, lens, clens),
                 (qc, kp, vp, pc, bt, lc, cl)):
        o = fa_ops.paged_flash_attention(*args, page_size=16, softcap=50.0)
        torch.cuda.synchronize()
        o_plain = fa_ops.paged_flash_attention_plain(*args, page_size=16,
                                                     softcap=50.0)
        valid = torch.arange(args[0].shape[1], device=dev)[None] < args[6][
            :, None]
        torch.testing.assert_close(o[valid], o_plain[valid], rtol=2e-5,
                                   atol=2e-5)


def _ring_inputs(dev, seed, T, W, lens, clens, Hq=16, Hkv=8, D=256):
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    q = torch.randn(B, T, Hq, D, generator=g, device=dev)
    kr, vr = (torch.randn(B, Hkv, W, D, generator=g, device=dev)
              for _ in range(2))
    kc, vc = (torch.randn(B, T, Hkv, D, generator=g, device=dev)
              for _ in range(2))
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    clens = torch.tensor(clens, dtype=torch.int32, device=dev)
    pos = (lens[:, None] + torch.arange(T, device=dev)[None]).to(torch.int32)
    return q, kr, vr, kc, vc, pos, lens, clens


# (label, T, W, lens, chunk_lens, D, window): decode over wrapped and
# unwritten rings; a ragged chunk with an empty row; a chunk longer than
# its ring; head_dims 256, 128 and 64
RING_SWEEP = [("decode_wrapped", 1, 256, (300, 17, 256, 0, 1000), (1,) * 5,
               256, 256),
              ("ragged", 40, 64, (0, 70, 5, 200), (40, 0, 33, 9), 256, 64),
              ("t_gt_w", 100, 32, (0, 50, 77), (100, 64, 3), 128, 32),
              ("window_narrower", 16, 128, (130, 7), (16, 16), 64, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("case", RING_SWEEP, ids=[c[0] for c in RING_SWEEP])
def test_ring_kernel_matches_plain(case, softcap):
    dev = _cuda_or_skip()
    _, T, W, lens, clens, D, window = case
    Hq, Hkv = (16, 8) if D == 256 else (32, 8)
    args = _ring_inputs(dev, T + W, T, W, lens, clens, Hq, Hkv, D)
    before = kernels.LAUNCHES["ring_flash_attention"]
    o = fa_ops.ring_flash_attention(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ring_flash_attention"] == before + 1
    o_plain = fa_ops.ring_flash_attention_plain(*args, window=window,
                                                softcap=softcap)
    valid = torch.arange(T, device=dev)[None] < args[7][:, None]
    torch.testing.assert_close(o[valid], o_plain[valid], rtol=2e-5,
                               atol=2e-5)
    # the same bits twice (split-KV sums in split order)
    assert torch.equal(o, fa_ops.ring_flash_attention(
        *args, window=window, softcap=softcap))


@pytest.mark.gpu
def test_flash_refuses_other_head_dims_and_the_backward_above_64():
    dev = _cuda_or_skip()
    q = torch.randn(1, 4, 2, 96, device=dev)
    pos = torch.arange(4, dtype=torch.int32, device=dev)[None].contiguous()
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, q[:, :, :1].contiguous(),
                               q[:, :, :1].contiguous(), pos, pos)
    q = torch.randn(1, 4, 2, 128, device=dev, requires_grad=True)
    k = torch.randn(1, 4, 1, 128, device=dev)
    out = fa_ops.flash_attention(q, k, k, pos, pos)
    with pytest.raises(NotImplementedError, match="item 25"):
        out.sum().backward()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_kernel_matches_plain_at_decode(seed):
    dev = _cuda_or_skip()
    args = _paged_decode_inputs(dev, seed)
    before = kernels.LAUNCHES["paged_flash_attention"]
    o = fa_ops.paged_flash_attention(*args, page_size=16)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_flash_attention"] == before + 1
    o_plain = fa_ops.paged_flash_attention_plain(*args, page_size=16)
    torch.testing.assert_close(o, o_plain, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mixed", "decode"])
def test_paged_kernel_matches_plain_at_group_1(case):
    """The paper models' engine ticks, 16 query and 16 kv heads: a mixed
    tick (8 slots, chunks of 128: prefill rows at several depths, two
    decode rows, an idle slot) and a pure decode tick. Only the rows of
    real tokens are compared (the engine discards pad rows)."""
    dev = _cuda_or_skip()
    if case == "decode":
        q, kp, vp, pos, bt, lens, clens = _paged_decode_inputs(dev, 3, Hq=16,
                                                               Hkv=16)
    else:
        g = torch.Generator(device=dev).manual_seed(4)
        i32 = dict(dtype=torch.int32, device=dev)
        B, C, H, D, page, nb, P = 8, 128, 16, 64, 16, 63, 512
        lens = torch.tensor([0, 128, 256, 384, 40, 700, 1000, 0], **i32)
        clens = torch.tensor([128, 128, 128, 100, 128, 1, 1, 0], **i32)
        need = (lens + clens + page - 1) // page
        perm = torch.randperm(P, generator=g, device=dev)
        bt = torch.full((B, nb), -1, **i32)
        used = 0
        for b in range(B):
            n = int(need[b])
            bt[b, :n] = perm[used:used + n].to(torch.int32)
            used += n
        kp = torch.randn(P, H, page, D, generator=g, device=dev)
        vp = torch.randn(P, H, page, D, generator=g, device=dev)
        q = torch.randn(B, C, H, D, generator=g, device=dev)
        pos = (lens[:, None] + torch.arange(C, device=dev)[None]).to(
            torch.int32)
    args = (q, kp, vp, pos, bt, lens, clens)
    o = fa_ops.paged_flash_attention(*args, page_size=16)
    torch.cuda.synchronize()
    o_plain = fa_ops.paged_flash_attention_plain(*args, page_size=16)
    valid = torch.arange(q.shape[1], device=dev)[None] < clens[:, None]
    torch.testing.assert_close(o[valid], o_plain[valid], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["prefill", "decode"])
def test_flash_kernel_is_deterministic(case):
    """The split-KV combine (decode) sums in a fixed order: two calls on
    the same inputs give the same bits."""
    dev = _cuda_or_skip()
    B, T, S = (1, 512, 512) if case == "prefill" else (8, 1, 1024)
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(B, T, 32, 64, generator=g, device=dev)
    k = torch.randn(B, S, 8, 64, generator=g, device=dev)
    v = torch.randn(B, S, 8, 64, generator=g, device=dev)
    qpos = torch.arange(S - T, S, dtype=torch.int32, device=dev)
    qpos = qpos[None].expand(B, T).contiguous()
    kpos = torch.arange(S, dtype=torch.int32, device=dev)
    kpos = kpos[None].expand(B, S).contiguous()
    o1 = fa_ops.flash_attention(q, k, v, qpos, kpos)
    o2 = fa_ops.flash_attention(q, k, v, qpos, kpos)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)


@pytest.mark.gpu
def test_paged_kernel_is_deterministic():
    dev = _cuda_or_skip()
    args = _paged_decode_inputs(dev, 3)
    o1 = fa_ops.paged_flash_attention(*args, page_size=16)
    o2 = fa_ops.paged_flash_attention(*args, page_size=16)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)


# head dims 128 and 256 (``wg_body``: wgmma row tiles; decode through the
# work list over the live keys): GQA groups 1, 4, 5, 6 and 8
WG_GROUPS = [(8, 8), (32, 8), (40, 8), (48, 8), (64, 8)]


def _wg_paged_mixed(dev, g, Hq, Hkv, D, C=24, page=16, nb=40, P=400):
    """A mixed tick: prefill rows at several depths, decode rows, idle
    slots between live ones, a -1 hole inside a context."""
    i32 = dict(dtype=torch.int32, device=dev)
    lens = torch.tensor([0, 0, 60, 300, 0, 7, 500, 0], **i32)
    clens = torch.tensor([24, 0, 24, 1, 0, 13, 1, 0], **i32)
    B = lens.shape[0]
    need = (lens + clens + page - 1) // page
    perm = torch.randperm(P, generator=g, device=dev)
    bt = torch.full((B, nb), -1, **i32)
    used = 0
    for b in range(B):
        n = int(need[b])
        bt[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    bt[3, 2] = -1
    kp = torch.randn(P, Hkv, page, D, generator=g, device=dev)
    vp = torch.randn(P, Hkv, page, D, generator=g, device=dev)
    q = torch.randn(B, C, Hq, D, generator=g, device=dev)
    pos = (lens[:, None] + torch.arange(C, device=dev)[None]).to(torch.int32)
    return q, kp, vp, pos, bt, lens, clens


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", [(None, None), (48, 30.0)])
@pytest.mark.parametrize("Hq,Hkv", WG_GROUPS,
                         ids=[f"g{h // k}" for h, k in WG_GROUPS])
@pytest.mark.parametrize("D", [128, 256])
def test_wg_flash_matches_plain_on_every_entry_point(D, Hq, Hkv, window,
                                                     softcap):
    """Contiguous prefill (-1 holes in kv_pos) and decode, paged mixed and
    decode (idle slots among live ones), the ring's chunk and decode: each
    within 2e-5 of its plain version, the same bits twice."""
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(D + Hq)
    kw = dict(window=window, softcap=softcap)
    for B, T, S in ((2, 80, 200), (4, 1, 700)):
        q = torch.randn(B, T, Hq, D, generator=g, device=dev)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        qpos = torch.arange(S - T, S, dtype=torch.int32, device=dev)
        qpos = qpos[None].expand(B, T).contiguous()
        kpos = torch.arange(S, dtype=torch.int32, device=dev)
        kpos = torch.where(kpos % 7 == 3, -1, kpos)[None].expand(
            B, S).contiguous()
        o = fa_ops.flash_attention(q, k, v, qpos, kpos, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            o, fa_ops.flash_attention_plain(q, k, v, qpos, kpos, **kw),
            rtol=2e-5, atol=2e-5)
        assert torch.equal(o, fa_ops.flash_attention(q, k, v, qpos, kpos,
                                                     **kw))
    for args in (_wg_paged_mixed(dev, g, Hq, Hkv, D),
                 _paged_decode_inputs(dev, D, Hq=Hq, Hkv=Hkv, D=D, nb=40,
                                      P=400)):
        o = fa_ops.paged_flash_attention(*args, page_size=16, **kw)
        torch.cuda.synchronize()
        o_plain = fa_ops.paged_flash_attention_plain(*args, page_size=16,
                                                     **kw)
        valid = torch.arange(args[0].shape[1], device=dev)[None] < args[6][
            :, None]
        torch.testing.assert_close(o[valid], o_plain[valid], rtol=2e-5,
                                   atol=2e-5)
        assert torch.equal(o, fa_ops.paged_flash_attention(
            *args, page_size=16, **kw))
    for T, lens, clens in ((24, (0, 70, 5, 0, 200), (24, 0, 17, 0, 24)),
                           (1, (300, 0, 17, 64, 1000), (1, 0, 1, 1, 1))):
        args = _ring_inputs(dev, T + D, T, 64, lens, clens, Hq, Hkv, D)
        o = fa_ops.ring_flash_attention(*args, **kw)
        torch.cuda.synchronize()
        o_plain = fa_ops.ring_flash_attention_plain(*args, **kw)
        valid = torch.arange(T, device=dev)[None] < args[7][:, None]
        torch.testing.assert_close(o[valid], o_plain[valid], rtol=2e-5,
                                   atol=2e-5)
        assert torch.equal(o, fa_ops.ring_flash_attention(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["prefill", "decode"])
@pytest.mark.parametrize("D", [128, 256])
def test_wg_flash_kernel_is_deterministic(D, case):
    """At head dims 128 and 256 (row tiles split over the context for one
    short prefill; decode split by the work list): the same bits twice."""
    dev = _cuda_or_skip()
    B, T, S = (1, 512, 512) if case == "prefill" else (8, 1, 1024)
    g = torch.Generator(device=dev).manual_seed(D)
    q = torch.randn(B, T, 32, D, generator=g, device=dev)
    k = torch.randn(B, S, 8, D, generator=g, device=dev)
    v = torch.randn(B, S, 8, D, generator=g, device=dev)
    qpos = torch.arange(S - T, S, dtype=torch.int32, device=dev)
    qpos = qpos[None].expand(B, T).contiguous()
    kpos = torch.arange(S, dtype=torch.int32, device=dev)
    kpos = kpos[None].expand(B, S).contiguous()
    o1 = fa_ops.flash_attention(q, k, v, qpos, kpos)
    o2 = fa_ops.flash_attention(q, k, v, qpos, kpos)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["paged", "ring"])
@pytest.mark.parametrize("D", [128, 256])
def test_wg_decode_graph_replays_new_lens_bit_for_bit(entry, D):
    """A decode call captured once in a CUDA graph and replayed after lens
    change (slots going idle, idle slots coming live, contexts growing
    past many tiles): the grid is set by the shapes, the work list is
    derived from lens on the card, so each replay equals the eager call
    bit for bit and the plain version within 2e-5."""
    dev = _cuda_or_skip()
    Hq, Hkv = (16, 8) if D == 256 else (40, 8)
    i32 = dict(dtype=torch.int32, device=dev)
    ticks = [([80, 0, 330, 0, 530, 1300, 7, 0], [1, 0, 1, 0, 1, 1, 1, 0]),
             ([0, 90, 331, 12, 0, 1301, 900, 0], [0, 1, 1, 1, 0, 1, 1, 0]),
             ([1400, 91, 0, 0, 0, 0, 0, 3], [1, 1, 0, 0, 0, 0, 0, 1])]
    if entry == "paged":
        q, kp, vp, pos, bt, lens, clens = _paged_decode_inputs(
            dev, 7, Hq=Hq, Hkv=Hkv, D=D, nb=96, P=800)
        bt.copy_(torch.arange(8 * 96, device=dev, dtype=torch.int32)
                 .reshape(8, 96) % 800)
        args = (q, kp, vp, pos, bt, lens, clens)

        def call():
            return fa_ops.paged_flash_attention(*args, page_size=16)

        def plain():
            return fa_ops.paged_flash_attention_plain(*args, page_size=16)
    else:
        args = _ring_inputs(dev, 7, 1, 256, [1] * 8, [1] * 8, Hq, Hkv, D)
        _, _, _, _, _, pos, lens, clens = args

        def call():
            return fa_ops.ring_flash_attention(*args, window=256,
                                               softcap=50.0)

        def plain():
            return fa_ops.ring_flash_attention_plain(*args, window=256,
                                                     softcap=50.0)
    call()                                   # sizes the workspace
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for tick_lens, tick_clens in ticks:
        lens.copy_(torch.tensor(tick_lens, **i32))
        clens.copy_(torch.tensor(tick_clens, **i32))
        pos.copy_(lens[:, None])
        graph.replay()
        eager = call()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        valid = clens > 0
        torch.testing.assert_close(out[valid], plain()[valid], rtol=2e-5,
                                   atol=2e-5)


# (B, T, H, N, chunk_lens): decode, a prefill chunk, ragged rows with an
# empty one, and the other instantiated head dims
WKV_CASES = [(8, 1, 64, 64, None), (2, 128, 8, 64, None),
             (4, 40, 4, 64, (40, 17, 0, 1)), (2, 70, 4, 16, None),
             (1, 33, 3, 8, (20,)), (2, 5, 2, 32, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,N,clens", WKV_CASES)
def test_wkv_kernel_matches_plain(B, T, H, N, clens):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(B * T + H * N)
    r, k, v = (torch.randn(B, T, H, N, generator=g, device=dev)
               for _ in range(3))
    w = torch.sigmoid(torch.randn(B, T, H, N, generator=g, device=dev)) \
        * 0.5 + 0.45
    u = torch.randn(H, N, generator=g, device=dev) * 0.3
    s0 = torch.randn(B, H, N, N, generator=g, device=dev) * 0.1
    if clens is not None:           # masked as the model masks ragged rows
        valid = (torch.arange(T, device=dev)[None] < torch.tensor(
            clens, device=dev)[:, None])[..., None, None]
        k = torch.where(valid, k, 0.0)
        w = torch.where(valid, w, 1.0)
    before = _wkv_launches()
    y, s = wkv_ops.rwkv6_wkv(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert _wkv_launches() == before + 1     # one of the two kernels
    y_plain, s_plain = wkv_ops.rwkv6_wkv_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, s_plain, rtol=1e-5, atol=1e-5)
    if clens is not None and 0 in clens:
        i = clens.index(0)
        assert torch.equal(s[i], s0[i])     # an empty chunk keeps its state


def _wkv_launches():
    return (kernels.LAUNCHES["rwkv6_wkv"]
            + kernels.LAUNCHES["rwkv6_wkv_chunk"])


def _wkv_inputs(dev, B, T, H, N, seed, decay="pallas"):
    """The Pallas sweep's inputs (w in [0.45, 0.95], u x 0.3, s0 x 0.1),
    decays as the model makes them ("model": exp(-exp(x)), x in [-6, -1]),
    or down to exact zeros ("small": x in [-6, 3], 2% zeros, 2% ones)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(B, T, H, N, generator=g, device=dev)
               for _ in range(3))
    if decay == "pallas":
        w = torch.sigmoid(torch.randn(B, T, H, N, generator=g, device=dev)) \
            * 0.5 + 0.45
    elif decay == "model":
        w = torch.exp(-torch.exp(-6.0 + 5.0 * torch.rand(
            B, T, H, N, generator=g, device=dev)))
    else:
        w = torch.exp(-torch.exp(-6.0 + 9.0 * torch.rand(
            B, T, H, N, generator=g, device=dev)))
        pick = torch.rand(B, T, H, N, generator=g, device=dev)
        w = torch.where(pick < 0.02, 0.0, torch.where(pick > 0.98, 1.0, w))
    u = torch.randn(H, N, generator=g, device=dev) * 0.3
    s0 = torch.randn(B, H, N, N, generator=g, device=dev) * 0.1
    return r, k, v, w, u, s0


# across the crossover (CHUNK_MIN_T = 8) and the 16-step sub-chunks
WKV_CHUNK_T = [1, 7, 8, 15, 16, 17, 33, 128, 200]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["recurrent", "chunk"])
@pytest.mark.parametrize("T", WKV_CHUNK_T)
def test_wkv_both_kernels_match_plain_at_any_t(T, kernel):
    dev = _cuda_or_skip()
    args = _wkv_inputs(dev, 2, T, 4, 64, T)
    y, s = wkv_ops.rwkv6_wkv(*args, kernel=kernel)
    y_plain, s_plain = wkv_ops.rwkv6_wkv_plain(*args)
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, s_plain, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["recurrent", "chunk"])
def test_wkv_kernels_take_small_decays_and_exact_zeros(kernel):
    dev = _cuda_or_skip()
    args = _wkv_inputs(dev, 2, 130, 4, 64, 5, decay="small")
    assert bool((args[3] == 0).any()) and bool((args[3] == 1).any())
    y, s = wkv_ops.rwkv6_wkv(*args, kernel=kernel)
    y_plain, s_plain = wkv_ops.rwkv6_wkv_plain(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, s_plain, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["recurrent", "chunk"])
def test_wkv_kernels_are_deterministic(kernel):
    dev = _cuda_or_skip()
    args = _wkv_inputs(dev, 8, 128, 64, 64, 9, decay="small")
    y1, s1 = wkv_ops.rwkv6_wkv(*args, kernel=kernel)
    y2, s2 = wkv_ops.rwkv6_wkv(*args, kernel=kernel)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.gpu
def test_wkv_picks_each_kernel_on_its_side_of_the_crossover():
    """auto: the recurrence below CHUNK_MIN_T, the chunked kernel from it
    on (N = 64); the recurrence for other head dims and for rows that are
    not 16-byte aligned, where forcing the chunked kernel raises."""
    dev = _cuda_or_skip()
    cut = wkv_ops.CHUNK_MIN_T
    for T, N, want in ((1, 64, "rwkv6_wkv"), (cut - 1, 64, "rwkv6_wkv"),
                       (cut, 64, "rwkv6_wkv_chunk"),
                       (128, 64, "rwkv6_wkv_chunk"), (128, 32, "rwkv6_wkv")):
        before = dict(kernels.LAUNCHES)
        wkv_ops.rwkv6_wkv(*_wkv_inputs(dev, 1, T, 2, N, 0))
        moved = {k for k in kernels.LAUNCHES
                 if kernels.LAUNCHES[k] != before[k]}
        assert moved == {want}, (T, N, moved)
    # r/k/v/w one float past a 16-byte boundary
    r, k, v, w, u, s0 = _wkv_inputs(dev, 1, 32, 2, 65, 0)
    r, k, v, w = (x[..., 1:] for x in (r, k, v, w))
    before = dict(kernels.LAUNCHES)
    y, s = wkv_ops.rwkv6_wkv(r, k, v, w, u[:, 1:].contiguous(),
                             s0[:, :, 1:, 1:].contiguous())
    assert kernels.LAUNCHES["rwkv6_wkv"] == before["rwkv6_wkv"] + 1
    with pytest.raises(ValueError, match="chunked"):
        wkv_ops.rwkv6_wkv(r, k, v, w, u[:, 1:].contiguous(),
                          s0[:, :, 1:, 1:].contiguous(), kernel="chunk")


@pytest.mark.gpu
def test_wkv_kernel_reads_strided_inputs_and_refuses_others():
    """r/k/v/w as views of one (B, T, 4, H, N) tensor: no copies."""
    dev = _cuda_or_skip()
    B, T, H, N = 2, 9, 4, 32
    g = torch.Generator(device=dev).manual_seed(3)
    rkvw = torch.randn(B, T, 4, H, N, generator=g, device=dev) * 0.5
    rkvw[:, :, 3] = torch.sigmoid(rkvw[:, :, 3])
    r, k, v, w = rkvw.unbind(dim=2)
    assert not r.is_contiguous()
    u = torch.randn(H, N, generator=g, device=dev)
    s0 = torch.randn(B, H, N, N, generator=g, device=dev)
    y, s = wkv_ops.rwkv6_wkv(r, k, v, w, u, s0)
    y_plain, s_plain = wkv_ops.rwkv6_wkv_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, s_plain, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="head_dim"):
        wkv_ops.rwkv6_wkv(*(torch.zeros(1, 2, 1, 24, device=dev),) * 4,
                          torch.zeros(1, 24, device=dev),
                          torch.zeros(1, 1, 24, 24, device=dev))
    with pytest.raises(TypeError):
        wkv_ops.rwkv6_wkv(r.double(), k.double(), v.double(), w.double(),
                          u, s0)


# (B, T, H, N, decay, chunk_lens) of the backward kernel: one train
# microbatch of rwkv6-7b, ragged rows masked as the model masks them (one
# empty), small decays with exact zeros, N = 32, and short T around its
# 8- and 64-step boundaries at the other head dims
WKV_BWD_CASES = [(2, 512, 64, 64, "model", None),
                 (4, 128, 64, 64, "model", (128, 100, 1, 0)),
                 (2, 130, 8, 64, "small", None),
                 (2, 100, 4, 32, "model", None),
                 (1, 1, 2, 8, "pallas", None), (2, 65, 3, 16, "pallas", None),
                 (1, 9, 2, 64, "small", (5,))]


def _wkv_bwd_args(dev, B, T, H, N, decay, clens, seed):
    r, k, v, w, u, s0 = _wkv_inputs(dev, B, T, H, N, seed, decay)
    if clens is not None:
        valid = (torch.arange(T, device=dev)[None] < torch.tensor(
            clens, device=dev)[:, None])[..., None, None]
        k = torch.where(valid, k, 0.0)
        w = torch.where(valid, w, 1.0)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn(B, T, H, N, generator=g, device=dev)
    ds = torch.randn(B, H, N, N, generator=g, device=dev)
    return (r, k, v, w, u, s0), dy, ds


def _close_rel_max(got, want, tol=1e-4):
    """Each gradient within ``tol`` of max |.| of the plain one."""
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(
            a, b, rtol=0, atol=tol * max(float(b.abs().max()), 1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,N,decay,clens", WKV_BWD_CASES)
def test_wkv_bwd_kernel_matches_plain(B, T, H, N, decay, clens):
    """dr, dk, dv, dw, du, ds0 against ``rwkv6_wkv_bwd_plain`` at 1e-4 of
    each gradient's max |.| (the f32 recurrence backwards, its sums in
    another order), with and without a state gradient; one launch
    counted per call."""
    dev = _cuda_or_skip()
    args, dy, ds = _wkv_bwd_args(dev, B, T, H, N, decay, clens, B * T + N)
    for dsx in (ds, None):
        before = kernels.LAUNCHES["rwkv6_wkv_bwd"]
        got = wkv_ops.rwkv6_wkv_bwd(*args, dy, dsx)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["rwkv6_wkv_bwd"] == before + 1
        want = wkv_ops.rwkv6_wkv_bwd_plain(*args, dy, dsx)
        assert all(bool(torch.isfinite(g).all()) for g in got)
        _close_rel_max(got, want)


@pytest.mark.gpu
def test_wkv_bwd_kernel_gives_the_same_bits_twice():
    dev = _cuda_or_skip()
    args, dy, ds = _wkv_bwd_args(dev, 2, 200, 8, 64, "small", None, 7)
    a = wkv_ops.rwkv6_wkv_bwd(*args, dy, ds)
    b = wkv_ops.rwkv6_wkv_bwd(*args, dy, ds)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["recurrent", "chunk"])
def test_wkv_bwd_either_kernel_matches_plain_at_n64(kernel):
    """At N = 64 both backward kernels can be forced: the chunked one (the
    default) and the recurrence it replaced, each at 1e-4 of max |.|."""
    dev = _cuda_or_skip()
    args, dy, ds = _wkv_bwd_args(dev, 2, 130, 8, 64, "small", None, 11)
    got = wkv_ops.rwkv6_wkv_bwd(*args, dy, ds, kernel=kernel)
    torch.cuda.synchronize()
    _close_rel_max(got, wkv_ops.rwkv6_wkv_bwd_plain(*args, dy, ds))


@pytest.mark.gpu
def test_chunked_wkv_bwd_refuses_other_head_dims():
    dev = _cuda_or_skip()
    args, dy, ds = _wkv_bwd_args(dev, 1, 20, 2, 32, "model", None, 3)
    with pytest.raises(ValueError, match="N = 64"):
        wkv_ops.rwkv6_wkv_bwd(*args, dy, ds, kernel="chunk")


@pytest.mark.gpu
def test_wkv_bwd_kernel_reads_strided_inputs_and_refuses_others():
    """r/k/v/w as views of one (B, T, 4, H, N) tensor, as the forward
    takes them; a dy that is not contiguous is refused."""
    dev = _cuda_or_skip()
    B, T, H, N = 2, 19, 4, 32
    g = torch.Generator(device=dev).manual_seed(4)
    rkvw = torch.randn(B, T, 4, H, N, generator=g, device=dev) * 0.5
    rkvw[:, :, 3] = torch.sigmoid(rkvw[:, :, 3])
    r, k, v, w = rkvw.unbind(dim=2)
    u = torch.randn(H, N, generator=g, device=dev)
    s0 = torch.randn(B, H, N, N, generator=g, device=dev)
    dy = torch.randn(B, T, H, N, generator=g, device=dev)
    got = wkv_ops.rwkv6_wkv_bwd(r, k, v, w, u, s0, dy)
    _close_rel_max(got, wkv_ops.rwkv6_wkv_bwd_plain(r, k, v, w, u, s0, dy))
    with pytest.raises(ValueError, match="contiguous dy"):
        wkv_ops.rwkv6_wkv_bwd(r, k, v, w, u, s0,
                              dy.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("T,fwd", [(512, "rwkv6_wkv_chunk"),
                                   (4, "rwkv6_wkv")])
def test_wkvfn_launches_the_forward_and_backward_kernels(T, fwd):
    """Inputs that need a gradient go through ``WkvFn``: one forward
    kernel (the one the wrapper picks by T), one backward launch, and the
    gradients of autograd through the plain recurrence."""
    dev = _cuda_or_skip()
    (r, k, v, w, u, s0), dy, _ = _wkv_bwd_args(dev, 2, T, 4, 64, "model",
                                               None, T)
    live = [x.clone().requires_grad_(True) for x in (r, k, v, w, u)]
    kernels.reset_launches()
    y, _ = wkv_ops.rwkv6_wkv(*live, s0)
    assert type(y.grad_fn).__name__ == "WkvFnBackward"
    (y * dy).sum().backward()
    torch.cuda.synchronize()
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        fwd: 1, "rwkv6_wkv_bwd": 1}
    ref = [x.clone().requires_grad_(True) for x in (r, k, v, w, u)]
    y_p, _ = wkv_ops.rwkv6_wkv_plain(*ref, s0)
    (y_p * dy).sum().backward()
    _close_rel_max([x.grad for x in live], [x.grad for x in ref])


@pytest.mark.gpu
def test_smoke_rwkv_engine_launches_the_kernels_and_matches_the_cpu():
    """Smoke-size rwkv6-7b (M8F8, two adapters) served on the card launches
    the wkv kernel once per layer per tick and the crossbar kernel seven
    times per layer per tick, and samples the same greedy tokens as the
    same engine on the CPU (the plain versions) on the same weights."""
    dev = _cuda_or_skip()
    cfg = reduce_config(get_config("rwkv6-7b"))
    g = torch.Generator().manual_seed(0)
    params = quant.quantize_params(tfm.init_params(cfg, g, device="cpu"),
                                   QuantConfig(8, 8), min_size=1)
    ads = []
    for _ in range(2):
        ad = lora_lib.init_lora_params(cfg, g, device="cpu")
        for entry in ad["layers"]:
            for ab in entry.values():
                ab["b"].normal_(0.0, 0.02, generator=g)
        ads.append(ad)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 11)]

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(to(v, device) for v in tree)
        if quant.is_quantized(tree):
            return quant.QuantizedTensor(tree.codes.to(device),
                                         tree.scales.to(device), tree.bits,
                                         tree.block, tree.orig_shape)
        return tree.to(device)

    runs = {}
    for device in ("cpu", dev):
        eng = make_engine(cfg, to(params, device), [to(a, device) for a in ads],
                          device=device, max_slots=2, max_len=32,
                          page_size=8, prefill_chunk=8, record_logits=True)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=4,
                               adapter_id=i % 2))
        kernels.reset_launches()
        done = eng.drain()
        torch.cuda.synchronize()
        runs[str(device)] = (done, dict(kernels.LAUNCHES),
                             eng.stats().ticks, eng)
    (cpu_done, cpu_l, _, cpu_eng), (done, launches, ticks, eng) = runs.values()
    assert all(n == 0 for n in cpu_l.values())
    assert launches["rwkv6_wkv"] == cfg.n_layers * ticks
    assert launches["crossbar_matmul"] == 7 * cfg.n_layers * ticks
    for uid in cpu_done:
        assert done[uid].tokens == cpu_done[uid].tokens
        torch.testing.assert_close(
            torch.stack(eng.sampled_logits[uid]).cpu(),
            torch.stack(cpu_eng.sampled_logits[uid]), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the engine's CUDA-graph step
# ---------------------------------------------------------------------------


def _smoke_model(arch, dev):
    """A smoke-size model on the card: M8F8 base, two adapters with B != 0,
    weights from seed 0 (the same on every call)."""
    cfg = reduce_config(get_config(arch))
    g = torch.Generator(device=dev).manual_seed(0)
    params = quant.quantize_params(tfm.init_params(cfg, g, device=dev),
                                   QuantConfig(8, 8), min_size=1)
    ads = []
    for _ in range(2):
        ad = lora_lib.init_lora_params(cfg, g, device=dev)
        for entry in ad["layers"]:
            for ab in entry.values():
                ab["b"].normal_(0.0, 0.02, generator=g)
        ads.append(ad)
    return cfg, params, ads


def _smoke_engine(arch, dev, **kw):
    """``_smoke_model``'s model in an engine on the card."""
    cfg, params, ads = _smoke_model(arch, dev)
    eng = make_engine(cfg, params, ads, device=dev, record_logits=True,
                      **{**dict(max_slots=3, max_len=48, page_size=4,
                                prefill_chunk=8), **kw})
    return cfg, eng


def _waves(eng, cfg, run, at=5):
    """Two waves of requests, the second submitted mid-run (at tick
    ``at``) so that new signatures (longer prompts, wider tables) meet
    repeated ones; ``run`` drives one tick."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 9, 5, 21, 14)]
    for i, p in enumerate(prompts[:3]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=6,
                           adapter_id=i % 2))
    ticks = 0
    while eng.queue or eng.sched.active():
        if ticks == at:
            for i, p in enumerate(prompts[3:], start=3):
                eng.submit(Request(uid=i, prompt=p, max_new_tokens=8,
                                   adapter_id=i % 2))
        run()
        ticks += 1
    torch.cuda.synchronize()
    return {uid: r.generated for uid, r in eng.finished.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b", "gemma2-9b",
                                  "llama4-scout-17b-a16e", "mixtral-8x22b",
                                  "jamba-1.5-large-398b"])
def test_graph_step_equals_the_eager_step(arch):
    """The graphed engine and the eager step on the same weights give the
    same greedy tokens and the same logits bits, over a run that repeats
    signatures and meets new ones mid-run. One graph per signature; every
    replay counts its kernels' launches, so both runs count alike."""
    dev = _cuda_or_skip()
    runs = {}
    for mode in ("eager", "graph"):
        cfg, eng = _smoke_engine(arch, dev)
        kernels.reset_launches()
        run = eng.step if mode == "graph" else (
            lambda e=eng: e._advance(e._eager))
        runs[mode] = (_waves(eng, cfg, run), dict(kernels.LAUNCHES), eng)
    (toks_e, launches_e, eng_e), (toks_g, launches_g, eng_g) = runs.values()
    assert toks_g == toks_e and len(toks_g) == 5
    for uid in toks_e:
        assert torch.equal(torch.stack(eng_g.sampled_logits[uid]),
                           torch.stack(eng_e.sampled_logits[uid]))
    assert launches_g == launches_e and launches_g["crossbar_matmul"] > 0
    st = eng_g.stats().compile
    assert st.compiled_steps == len(st.step_signatures) == len(eng_g._graphs)
    assert st.compiled_steps >= 3                 # signatures met mid-run
    assert st.replays == eng_g.stats().ticks - st.compiled_steps > 0
    assert st.graph_pool_bytes > 0 and st.capture_ms > 0
    assert eng_e.stats().compile.compiled_steps == 0


@pytest.mark.gpu
def test_replayed_step_does_not_sync_and_workspaces_stay_fixed():
    """A replay (and the eager step it captured) makes no host sync, and a
    later signature reuses the workspaces reserved before the first
    capture."""
    dev = _cuda_or_skip()
    cfg, eng = _smoke_engine("llama3.2-1b", dev)
    fixed = [ops.WORKSPACES.current(eng.device.index)
             for ops in (cb_ops, fa_ops)]
    assert all(ws is not None for ws in fixed)
    ptrs = [(ws[0].data_ptr(), ws[1].data_ptr()) for ws in fixed]
    rng = np.random.default_rng(1)
    eng.submit(Request(uid=0, prompt=rng.integers(
        0, cfg.vocab_size, 30).astype(np.int32), max_new_tokens=12))
    sigs = []

    def recording(sig, staged):
        sigs.append(sig)
        return eng._replay(sig, staged)

    while eng.replays == 0 and (eng.queue or eng.sched.active()):
        eng._advance(recording)
    assert eng.replays == 1
    # the last tick again, by replay and eagerly: the same K/V to the same
    # places (llama keeps no other state), with every host sync an error
    g = eng._graphs[sigs[-1]]
    staged = eng._host[:g.inputs.numel()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.inputs.copy_(staged, non_blocking=True)
        g.graph.replay()
        eng._step_fn(g.inputs, *sigs[-1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.drain()
    torch.cuda.synchronize()
    assert len(eng._graphs) >= 2
    assert ptrs == [(ws[0].data_ptr(), ws[1].data_ptr()) for ws in
                    (ops.WORKSPACES.current(eng.device.index)
                     for ops in (cb_ops, fa_ops))]


@pytest.mark.gpu
def test_a_failed_capture_raises_with_its_signature():
    """A step that waits for the device cannot be captured: the engine
    raises, naming the signature, and does not fall back to eager."""
    dev = _cuda_or_skip()
    cfg, eng = _smoke_engine("llama3.2-1b", dev)
    step_fn = eng._step_fn

    def syncing(inputs, C, nb):
        out = step_fn(inputs, C, nb)
        if torch.cuda.is_current_stream_capturing():
            float(out.sum())             # a host read: illegal in capture
        return out

    eng._step_fn = syncing
    eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32) + 1,
                       max_new_tokens=3))
    stream = torch.cuda.current_stream(dev)
    with pytest.raises(Exception) as info:
        eng.step()
    assert torch.cuda.current_stream(dev) == stream
    assert any("signature (C=" in n for n in getattr(info.value,
                                                     "__notes__", []))
    assert not eng._graphs


@pytest.mark.gpu
def test_paper_model_engine_ticks_match_the_plain_forward():
    """Smoke-size paper-gpt2-medium (LayerNorm, 4/4 heads, a tanh-GELU MLP)
    served on the card by CUDA graphs: six crossbar launches and one paged
    flash launch per layer per tick, and every request's sampled logits
    within 1e-4 of a teacher-forced plain forward (dequantized weights,
    ``ref_attention``) of its prompt and its tokens."""
    dev = _cuda_or_skip()
    cfg, params, ads = _smoke_model("paper-gpt2-medium", dev)
    eng = make_engine(cfg, params, ads, device=dev, record_logits=True,
                      max_slots=3, max_len=48, page_size=4, prefill_chunk=8)
    rng = np.random.default_rng(2)
    for i, n in enumerate((6, 17, 11)):
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=5,
            adapter_id=i % 2))
    kernels.reset_launches()
    done = eng.drain()
    torch.cuda.synchronize()
    ticks = eng.stats().ticks
    L = cfg.n_layers
    assert kernels.LAUNCHES["crossbar_matmul"] == 6 * L * ticks
    assert kernels.LAUNCHES["paged_flash_attention"] == L * ticks
    assert eng.replays > 0 and eng.stats().compile.compiled_steps > 0
    plain = quant.dequantize_params(params)
    ref_ec = tfm.ExecConfig(attn_impl="ref")
    stacked = lora_lib.stack_adapters(ads)
    for uid, r in done.items():
        toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1],
                                                    np.int32)])
        lg, _, _ = tfm.forward(
            cfg, plain, {"tokens": torch.as_tensor(toks, device=dev)[None]},
            lora=stacked, adapter_idx=torch.tensor([r.adapter_id],
                                                   device=dev),
            mode="prefill", exec_cfg=ref_ec)
        want = lg[0, len(r.prompt) - 1:]
        got = torch.stack(eng.sampled_logits[uid])
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training: the backward kernels, and gradients that the kernels carry
# ---------------------------------------------------------------------------

# (M, K, N): the forward's ragged shapes, a decode-sized M, the training
# step's M = B * T = 2048 at llama's and the paper models' widths, and one
# train microbatch's M = 1024 at llama's four and the paper models' three
# (K, N) pairs
CB_T_SHAPES = [(8, 300, 130), (100, 520, 250), (2048, 2048, 512),
               (8, 2048, 8192), (100, 1024, 4096), (2048, 4096, 1024),
               (1024, 2048, 2048), (1024, 2048, 512), (1024, 2048, 8192),
               (1024, 8192, 2048), (1024, 1024, 1024), (1024, 1024, 4096),
               (1024, 4096, 1024),
               # the Fig. 13 fine-tunes' dx (K = 128: half of one 256-row
               # tile of codes)
               (1024, 128, 128), (1024, 128, 512), (1024, 512, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mkn", CB_T_SHAPES)
def test_crossbar_t_kernel_matches_plain(bits, mkn):
    """dx = g . dequant(W)^T from the same codes: the forward's tolerance,
    1e-4 of max |dx| (f32 sums in another order)."""
    dev = _cuda_or_skip()
    M, K, N = mkn
    gen = torch.Generator(device=dev).manual_seed(M + K + N + bits)
    w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
    g = torch.randn(M, N, generator=gen, device=dev)
    qt = quant.quantize(w, bits)
    before = kernels.LAUNCHES["crossbar_matmul_t"]
    dx = cb_ops.crossbar_matmul_t(g, qt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crossbar_matmul_t"] == before + 1
    ref = cb_ops.crossbar_matmul_t_plain(g, qt)
    assert dx.shape == (M, K)
    torch.testing.assert_close(dx, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_crossbar_t_kernel_gives_the_same_bits_twice(bits):
    """Two calls on the same inputs, on a microbatch shape whose N
    reduction the kernel splits over blocks (summed in rank order through
    the workspace): identical bits."""
    dev = _cuda_or_skip()
    M, K, N = 1024, 1024, 4096
    gen = torch.Generator(device=dev).manual_seed(7 + bits)
    w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
    g = torch.randn(M, N, generator=gen, device=dev)
    qt = quant.quantize(w, bits)
    kp = qt.codes.shape[0] * (2 if bits == 4 else 1)
    assert cb_ops._need(M, kp, qt.codes.shape[1], bits, "t")[0] > 0
    dx1 = cb_ops.crossbar_matmul_t(g, qt)
    dx2 = cb_ops.crossbar_matmul_t(g, qt)
    torch.cuda.synchronize()
    assert torch.equal(dx1, dx2)


@pytest.mark.gpu
def test_crossbar_autograd_runs_both_kernels():
    """A CUDA x that needs a gradient: the forward kernel, then dx by the
    transposed kernel; the codes and scales get none."""
    dev = _cuda_or_skip()
    x, qt = _crossbar_inputs(dev, 3 * 40, 640, 384, 8, 5)
    x = x.reshape(3, 40, 640).requires_grad_(True)
    gy = torch.randn(3, 40, 384, device=dev)
    kernels.reset_launches()
    y = cb_ops.crossbar_matmul(x, qt)
    (y * gy).sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crossbar_matmul"] == 1
    assert kernels.LAUNCHES["crossbar_matmul_t"] == 1
    assert not qt.codes.requires_grad and not qt.scales.requires_grad
    ref = cb_ops.crossbar_matmul_t_plain(gy, qt)
    torch.testing.assert_close(x.grad, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


def _bwd_inputs(dev, B, T, Hq, Hkv, D, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, dout = (torch.randn(B, T, Hq, D, generator=gen, device=dev)
               for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device=dev)
            for _ in range(2))
    pos = torch.arange(T, device=dev, dtype=torch.int32)[None].expand(
        B, T).contiguous()
    return q, k, v, pos, dout


def _bwd_check(q, k, v, qpos, kpos, dout, window=None, softcap=None):
    """The backward kernels against the plain version (1e-4 relative and
    absolute) from the kernel's own forward, one launch counted; returns
    the kernels' grads and the forward's (out, lse)."""
    out, lse = fa_ops._launch(q, k, v, qpos, kpos, window, softcap,
                              with_lse=True)
    before = kernels.LAUNCHES["flash_attention_bwd"]
    got = fa_ops.flash_attention_bwd(q, k, v, qpos, kpos, out, lse, dout,
                                     window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_bwd"] == before + 1
    want = fa_ops.flash_attention_bwd_plain(q, k, v, qpos, kpos, out, lse,
                                            dout, window=window,
                                            softcap=softcap)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    return got, (out, lse)


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", FA_FLAGS + [(4, 30.0)])
@pytest.mark.parametrize("D", [8, 64])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("T", [96, 300])
def test_flash_bwd_kernel_matches_plain(T, Hq, Hkv, D, window, softcap):
    """dq, dk, dv against the plain blocked recompute, from the kernel's own
    forward (out, lse): 1e-4 relative and absolute, as the JAX package
    holds its custom VJP to ref_attention's gradients."""
    dev = _cuda_or_skip()
    q, k, v, pos, dout = _bwd_inputs(dev, 2, T, Hq, Hkv, D, T + Hq + D)
    _, (out, lse) = _bwd_check(q, k, v, pos, pos, dout, window, softcap)
    out_p, lse_p = fa_ops.flash_attention_plain(
        q, k, v, pos, pos, window=window, softcap=softcap, with_lse=True)
    torch.testing.assert_close(out, out_p, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (16, 16)])
def test_flash_bwd_kernel_matches_plain_at_the_microbatch(Hq, Hkv):
    """One train microbatch's attention: B = 2, T = S = 512 causal, at
    llama3.2-1b's 32/8 and the paper models' 16/16 heads (long key and
    row lists split over blocks)."""
    dev = _cuda_or_skip()
    q, k, v, pos, dout = _bwd_inputs(dev, 2, 512, Hq, Hkv, 64, Hq + Hkv)
    _bwd_check(q, k, v, pos, pos, dout)


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (8, 2)])
def test_flash_bwd_kernel_gives_the_same_bits_twice(Hq, Hkv):
    """Two backward calls on the same inputs, with dk/dv and dq summed
    over split blocks: identical bits (no atomics on any output)."""
    dev = _cuda_or_skip()
    T = 512 if Hq == 32 else 300
    q, k, v, pos, dout = _bwd_inputs(dev, 2, T, Hq, Hkv, 64, 11)
    got, (out, lse) = _bwd_check(q, k, v, pos, pos, dout)
    again = fa_ops.flash_attention_bwd(q, k, v, pos, pos, out, lse, dout)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 64])
def test_flash_bwd_rows_that_see_no_key(D):
    """Rows at position -1 see no key and keys at -1 are seen by no row:
    their dq, and their dk and dv, are 0; the rest match the plain
    version."""
    dev = _cuda_or_skip()
    q, k, v, pos, dout = _bwd_inputs(dev, 2, 200, 8, 2, D, 13)
    qpos, kpos = pos.clone(), pos.clone()
    qpos[0, 150:] = -1
    qpos[1, :] = -1              # a whole sequence sees nothing
    kpos[0, :70] = -1
    (dq, dk, dv), _ = _bwd_check(q, k, v, qpos, kpos, dout)
    assert torch.all(dq[0, 150:] == 0) and torch.all(dq[1] == 0)
    assert torch.all(dk[0, :70] == 0) and torch.all(dv[0, :70] == 0)
    assert torch.all(dk[1] == 0) and torch.all(dv[1] == 0)


@pytest.mark.gpu
def test_flash_forward_without_lse_is_unchanged():
    """The serving call (no lse) gives the same bits as the call that also
    writes lse, on a row-tile and a split-KV (decode) shape."""
    dev = _cuda_or_skip()
    for B, T, S in ((2, 300, 300), (8, 1, 1000)):
        gen = torch.Generator(device=dev).manual_seed(T)
        q = torch.randn(B, T, 32, 64, generator=gen, device=dev)
        k, v = (torch.randn(B, S, 8, 64, generator=gen, device=dev)
                for _ in range(2))
        qpos = (torch.arange(T, device=dev, dtype=torch.int32)
                + (S - T))[None].expand(B, T).contiguous()
        kpos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(
            B, S).contiguous()
        o1 = fa_ops.flash_attention(q, k, v, qpos, kpos)
        o2, lse = fa_ops._launch(q, k, v, qpos, kpos, None, None,
                                 with_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(o1, o2)
        _, lse_p = fa_ops.flash_attention_plain(q, k, v, qpos, kpos,
                                                with_lse=True)
        torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


def _grads(cfg, params, lora, batch, ec):
    loss_fn = steps.make_loss_fn(cfg, ec)
    return steps.value_and_grad(loss_fn, lora, params, batch, None)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "paper-gpt2-medium"])
def test_lora_grads_through_the_kernels_equal_the_plain_ones(arch):
    """A 2-layer model on an M8F8 base: the loss and every LoRA gradient
    with the kernels (crossbar and flash forward and backward) against
    dequantized weights, ``torch.matmul``, ref attention and autograd. The
    graph is not cut: every leaf gets a gradient, and every kernel ran as
    often as the model has matrices and layers."""
    dev = _cuda_or_skip()
    cfg = reduce_config(get_config(arch))
    gen = torch.Generator(device=dev).manual_seed(3)
    base = tfm.init_params(cfg, gen, device=dev)
    params = quant.quantize_params(base, QuantConfig(8, 8), min_size=1)
    lora = lora_lib.init_lora_params(cfg, gen, device=dev)
    for entry in lora["layers"]:
        for ab in entry.values():
            ab["b"].normal_(0.0, 0.02, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    kernels.reset_launches()
    (loss_k, _), g_k = _grads(cfg, params, lora, batch, tfm.ExecConfig())
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    (loss_p, _), g_p = _grads(cfg, quant.dequantize_params(params), lora,
                              batch, tfm.ExecConfig(attn_impl="ref"))
    n_quant = sum(qt.codes.shape[0]
                  for qt in tfm._quantized(params["layers"]))
    per_layer = n_quant // cfg.n_layers
    assert launches["crossbar_matmul"] == n_quant
    # layer 0's q/k/v projections read the embedding, which needs no grad
    assert launches["crossbar_matmul_t"] == n_quant - 3
    assert launches["flash_attention"] == cfg.n_layers
    assert launches["flash_attention_bwd"] == cfg.n_layers
    assert per_layer in (6, 7)
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for a, b in zip(adamw.leaves(g_k), adamw.leaves(g_p)):
        assert float(b.norm()) > 0
        assert float((a - b).norm()) <= 1e-4 * float(b.norm())


def _smoke_train_state(arch, dev, seed=3):
    cfg = reduce_config(get_config(arch))
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = tfm.init_params(cfg, gen, device=dev)
    params = quant.quantize_params(base, QuantConfig(8, 8), min_size=1)
    lora = lora_lib.init_lora_params(cfg, gen, device=dev)
    for entry in lora["layers"]:
        for ab in entry.values():
            ab["b"].normal_(0.0, 0.02, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (4, 41), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    return cfg, params, lora, batch


# reduced rwkv6-7b's LoRA gradients, kernels against plain versions:
# relative L2. The crossbar kernels carry their f32 operand as bf16
# pieces (|x - hi - lo| <= 2^-16 |x|), and a 2^-16 relative weight
# perturbation moves this model's LoRA gradients by 2-7e-4 on the CPU
# (``grad_sensitivity`` of benchmarks/torch_rwkv_conditioning.py at
# reduce_config), against 0.9-1.5e-4 for llama's: rwkv's bound is 1e-3,
# llama's stays 1e-4.
RWKV_GRAD_TOL_REL = 1e-3


@pytest.mark.gpu
def test_rwkv_lora_grads_through_the_kernels_equal_the_plain_ones():
    """Reduced rwkv6-7b on an M8F8 base: the loss and every LoRA gradient
    with the kernels (crossbar forward and dx, the wkv forward and its
    backward kernel) against dequantized weights, ``torch.matmul`` and
    autograd of the plain recurrence (``RWKV_GRAD_TOL_REL``). Every
    kernel ran as often as the model has matrices and layers; layer 0's
    r/k/v/g projections read the frozen embedding only, so they have no
    dx."""
    dev = _cuda_or_skip()
    cfg, params, lora, batch = _smoke_train_state("rwkv6-7b", dev)
    kernels.reset_launches()
    (loss_k, _), g_k = _grads(cfg, params, lora, batch, tfm.ExecConfig())
    torch.cuda.synchronize()
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    (loss_p, _), g_p = _grads(cfg, quant.dequantize_params(params), lora,
                              batch, tfm.ExecConfig(rwkv_impl="ref"))
    n_quant = sum(qt.codes.shape[0]
                  for qt in tfm._quantized(params["layers"]))
    assert n_quant == 7 * cfg.n_layers
    assert launches == {"crossbar_matmul": n_quant,
                        "crossbar_matmul_t": n_quant - 4,
                        "rwkv6_wkv": cfg.n_layers,
                        "rwkv6_wkv_bwd": cfg.n_layers}
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for a, b in zip(adamw.leaves(g_k), adamw.leaves(g_p)):
        assert float(b.norm()) > 0
        assert float((a - b).norm()) <= RWKV_GRAD_TOL_REL * float(b.norm())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,noise", [("llama3.2-1b", False),
                                        ("paper-gpt2-medium", True),
                                        ("rwkv6-7b", False),
                                        ("rwkv6-7b", True)])
def test_remat_gives_the_same_bits_on_the_card(arch, noise):
    """``ExecConfig(remat=True)``: a step's loss and every LoRA gradient
    (2 microbatches) bit-equal to those without remat, with weight noise
    from a CUDA generator where ``noise``; every forward kernel launches
    twice as often, every backward kernel as often. None of the kernels
    uses atomics, so any difference is a fault."""
    dev = _cuda_or_skip()
    cfg, params, lora, batch = _smoke_train_state(arch, dev)
    runs = []
    for remat in (False, True):
        ec = tfm.ExecConfig(remat=remat, noise=NoiseConfig(
            enabled=noise, sigma_rel=0.02))
        rng = (torch.Generator(device=dev).manual_seed(5) if noise
               else None)
        kernels.reset_launches()
        loss, _, g = steps.accumulate_grads(
            steps.make_loss_fn(cfg, ec), lora, params, batch, 2, rng)
        torch.cuda.synchronize()
        runs.append((loss, list(adamw.leaves(g)),
                     {k: n for k, n in kernels.LAUNCHES.items() if n},
                     rng.get_state() if noise else None))
    (l0, g0, n0, st0), (l1, g1, n1, st1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    if noise:
        assert torch.equal(st0, st1)
    backward = ("crossbar_matmul_t", "flash_attention_bwd", "rwkv6_wkv_bwd")
    assert n1 == {k: n * (1 if k in backward else 2) for k, n in n0.items()}
    assert any(k in n0 for k in backward)


@pytest.mark.gpu
def test_kernels_without_backward_raise_under_grad():
    """The paged and ring flash kernels have no backward: on CUDA inputs
    that need a gradient each raises, never returning a tensor that cuts
    the graph; under no_grad it runs. rwkv6_wkv has one now: under grad it
    goes through ``WkvFn``."""
    dev = _cuda_or_skip()
    B, T, H, N = 1, 4, 2, 16
    r, k, v, w = (torch.rand(B, T, H, N, device=dev) for _ in range(4))
    u = torch.rand(H, N, device=dev)
    s0 = torch.zeros(B, H, N, N, device=dev)
    r.requires_grad_(True)
    y, _ = wkv_ops.rwkv6_wkv(r, k, v, w, u, s0)
    assert type(y.grad_fn).__name__ == "WkvFnBackward"
    with torch.no_grad():
        assert wkv_ops.rwkv6_wkv(r, k, v, w, u, s0)[0].grad_fn is None
    q = torch.randn(1, 2, 4, 16, device=dev, requires_grad=True)
    kp = torch.randn(3, 2, 4, 16, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    args = (q, kp, kp.clone(), torch.tensor([[0, 1]], **i32),
            torch.tensor([[0]], **i32), torch.tensor([0], **i32),
            torch.tensor([2], **i32))
    with pytest.raises(NotImplementedError, match="no backward"):
        fa_ops.paged_flash_attention(*args, page_size=4)
    with torch.no_grad():
        fa_ops.paged_flash_attention(*args, page_size=4)
    ring = _ring_inputs(dev, 0, 2, 4, (3,), (2,), Hq=4, Hkv=2, D=16)
    ring[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        fa_ops.ring_flash_attention(*ring)
    with torch.no_grad():
        fa_ops.ring_flash_attention(*ring)


@pytest.mark.gpu
def test_launcher_trains_checkpoints_and_restores_on_the_card(tmp_path,
                                                              capsys):
    """``launch.train`` at smoke size on the card, M8F8 base, with a
    checkpoint directory: 20 steps save a checkpoint at step 20 (the
    trainer's ``ckpt_every``); a second launch with ``--steps 22``
    restores it onto the card and runs steps 21 and 22 through all four
    training kernels; a third with ``--steps 20`` restores and runs
    nothing."""
    dev = _cuda_or_skip()
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", str(dev),
            "--batch", "2", "--seq", "32", "--microbatches", "2", "--quant",
            "M8F8", "--ckpt-dir", str(tmp_path)]
    log = launch_train.main(args + ["--steps", "20"])
    assert [r["step"] for r in log] == list(range(1, 21))
    assert (tmp_path / "step_00000020" / "manifest.json").exists()
    kernels.reset_launches()
    log = launch_train.main(args + ["--steps", "22"])
    assert [r["step"] for r in log] == [21, 22]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert all(kernels.LAUNCHES[k] > 0 for k in (
        "crossbar_matmul", "crossbar_matmul_t", "flash_attention",
        "flash_attention_bwd"))
    assert launch_train.main(args + ["--steps", "20"]) == []
    assert "restored at step 20" in capsys.readouterr().out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b",
                                  "paper-gpt2-medium"])
def test_dense_engine_graph_equals_its_eager_step(arch):
    """The dense oracle engine on the card: its decode step replayed from
    one CUDA graph gives the eager step's tokens and logits bits, over a
    run that reuses slots and prefills prompts of several buckets; its
    launches count alike; its greedy tokens equal the CPU engine's on the
    same weights (the plain versions)."""
    dev = _cuda_or_skip()
    cfg, params, ads = _smoke_model(arch, dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 9, 5, 21, 14)]
    runs = {}
    for mode in ("eager", "graph"):
        eng = make_engine(cfg, params, ads, mode="dense", device=dev,
                          max_batch=3, max_len=48, record_logits=True)
        if mode == "eager":
            eng._replay = eng._eager
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6,
                               adapter_id=i % 2))
        kernels.reset_launches()
        done = eng.drain()
        torch.cuda.synchronize()
        runs[mode] = (done, dict(kernels.LAUNCHES), eng)
    (done_e, launches_e, eng_e), (done_g, launches_g, eng_g) = runs.values()
    assert {u: c.tokens for u, c in done_g.items()} == {
        u: c.tokens for u, c in done_e.items()}
    for uid in done_e:
        assert torch.equal(torch.stack(eng_g.sampled_logits[uid]),
                           torch.stack(eng_e.sampled_logits[uid]))
    assert launches_g == launches_e and launches_g["crossbar_matmul"] > 0
    st = eng_g.stats().compile
    assert st.compiled_steps == 1 and st.replays == eng_g.stats().ticks - 1
    assert eng_e.stats().compile.compiled_steps == 0
    cpu = make_engine(cfg, _to_cpu(params), [_to_cpu(a) for a in ads],
                      mode="dense", device="cpu", max_batch=3, max_len=48)
    for i, p in enumerate(prompts):
        cpu.submit(Request(uid=i, prompt=p, max_new_tokens=6,
                           adapter_id=i % 2))
    assert {u: c.tokens for u, c in cpu.drain().items()} == {
        u: c.tokens for u, c in done_g.items()}


def _to_cpu(tree):
    if quant.is_quantized(tree):
        return quant.QuantizedTensor(tree.codes.cpu(), tree.scales.cpu(),
                                     tree.bits, tree.block, tree.orig_shape)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.cpu()


class _ScriptDrafter:
    """Proposes the first k - 1 tokens of a known greedy continuation and
    then a wrong one, so that every verify chunk accepts drafts and then
    rejects one, the same way in every run. ``truth`` maps a prompt to its
    greedy tokens."""

    def __init__(self, truth):
        self.truth = truth

    def propose(self, streams, adapter_ids, k):
        out = []
        for s in streams:
            for prompt, toks in self.truth.items():
                n = len(prompt)
                if tuple(s[:n]) == prompt:
                    i = len(s) - n
                    nxt = list(toks[i:i + k])
                    if len(nxt) == k:        # the last one made wrong
                        nxt[-1] = (nxt[-1] + 1) % 256
                    out.append(np.asarray(nxt, np.int32))
                    break
        return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_spec_verify_graph_equals_the_eager_verify_step(arch):
    """Speculative decoding on the card: the verify step replayed from one
    CUDA graph per signature gives the eager verify step's tokens and
    logits bits (the rwkv snapshot copied inside the graph, restored after
    it), over waves whose verify chunks accept drafts and then reject one
    (the drafts scripted from the spec-off engine's greedy tokens); both
    count the same launches; one graph per signature; the greedy tokens
    equal the spec-off engine's and the CPU engine's on the same weights."""
    from repro_torch.serve.spec import SpecConfig
    dev = _cuda_or_skip()
    cfg, plain = _smoke_engine(arch, dev)
    truth = _waves(plain, cfg, plain.step, at=2)
    drafter = _ScriptDrafter({tuple(int(t) for t in r.prompt): r.generated
                              for r in plain.finished.values()})
    runs = {}
    for mode in ("eager", "graph"):
        cfg, eng = _smoke_engine(arch, dev, spec=SpecConfig(k=3))
        eng.drafter = drafter
        kernels.reset_launches()
        run = eng.step if mode == "graph" else (
            lambda e=eng: e._advance(e._eager))
        runs[mode] = (_waves(eng, cfg, run, at=2), dict(kernels.LAUNCHES),
                      eng)
    (toks_e, launches_e, eng_e), (toks_g, launches_g, eng_g) = runs.values()
    assert toks_g == toks_e == truth and len(toks_g) == 5
    for uid in toks_e:
        assert torch.equal(torch.stack(eng_g.sampled_logits[uid]),
                           torch.stack(eng_e.sampled_logits[uid]))
    assert launches_g == launches_e and launches_g["crossbar_matmul"] > 0
    st = eng_g.stats()
    assert st.compile.compiled_steps == len(st.compile.step_signatures)
    assert st.compile.replays == st.ticks - st.compile.compiled_steps > 0
    assert st.spec.accepted_tokens > 0 and st.spec.rolled_back_tokens > 0
    if arch in ("rwkv6-7b", "jamba-1.5-large-398b"):
        assert st.spec.recurrent_rollbacks > 0
    cfg, params, ads = _smoke_model(arch, dev)
    cpu = make_engine(cfg, _to_cpu(params), [_to_cpu(a) for a in ads],
                      device="cpu", max_slots=3, max_len=48, page_size=4,
                      prefill_chunk=8, spec=SpecConfig(k=3))
    cpu.drafter = drafter
    assert _waves(cpu, cfg, cpu.step, at=2) == toks_g


@pytest.mark.gpu
def test_scatter_pages_writes_into_the_tensors_the_graphs_captured(tmp_path):
    """After an engine's graphs are captured, ``scatter_pages`` writes into
    the very pool tensors they captured (pointers unchanged, contents as
    written), and a prefix file loaded into the live engine then serves a
    sharer by replay with the saving engine's tokens."""
    dev = _cuda_or_skip()
    cfg, saver = _smoke_engine("llama3.2-1b", dev, max_len=64)
    rng = np.random.default_rng(7)
    head = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    req = np.concatenate([head, [3, 4]]).astype(np.int32)
    saver.submit(Request(uid=0, prompt=req, max_new_tokens=5))
    want = saver.drain()[0].tokens
    path = str(tmp_path / "prefix.npz")
    assert saver.save_prefix_cache(path) > 0

    cfg, eng = _smoke_engine("llama3.2-1b", dev, max_len=64)
    _waves(eng, cfg, eng.step)
    assert eng._graphs
    eng.release_prefix_cache()
    ptrs = [leaf.data_ptr() for e in eng.cache["layers"]
            for leaf in e.values()]
    free = eng.sched.alloc.alloc(2)
    data = [{name: np.random.default_rng(1).standard_normal(
        (leaf.shape[0], 2) + tuple(leaf.shape[2:])).astype(np.float32)
        for name, leaf in e.items()} for e in eng.cache["layers"]]
    assert kvcache.scatter_pages(eng.cache, free, data) is eng.cache
    assert ptrs == [leaf.data_ptr() for e in eng.cache["layers"]
                    for leaf in e.values()]
    for got, w in zip(kvcache.gather_pages(eng.cache, free), data):
        for name in w:
            np.testing.assert_array_equal(got[name], w[name])
    eng.sched.alloc.free(free)
    _, loaded = eng.prefix.load(path, eng.cache)
    assert loaded > 0 and ptrs == [leaf.data_ptr() for e in
                                   eng.cache["layers"] for leaf in e.values()]
    replays, hits = eng.replays, eng.prefix_hit_tokens
    eng.submit(Request(uid=99, prompt=req, max_new_tokens=5))
    assert eng.drain()[99].tokens == want
    assert eng.prefix_hit_tokens > hits and eng.replays > replays


@pytest.mark.gpu
def test_selfdraft_graphs_equal_its_eager_drafts():
    """The quantized self-drafter on the card: its drafts by CUDA graph
    (one per (context bucket, k), captured after an eager first call)
    equal its eager drafts, count the same launches (int4 crossbar and
    contiguous flash, k forwards a call), and its crossbar weights are
    int4."""
    from repro_torch.serve.spec import QuantSelfDrafter, SpecConfig
    dev = _cuda_or_skip()
    cfg = reduce_config(get_config("llama3.2-1b"))
    g = torch.Generator(device=dev).manual_seed(0)
    params = tfm.init_params(cfg, g, device=dev)
    ads = lora_lib.stack_adapters([lora_lib.init_lora_params(cfg, g,
                                                             device=dev)])
    spec = SpecConfig(k=3, drafter="selfdraft", draft_ctx=16)
    dr = QuantSelfDrafter(cfg, params, ads, spec, tfm.ExecConfig(), 3)
    eager = QuantSelfDrafter(cfg, params, ads, spec, tfm.ExecConfig(), 3)
    eager._run = eager._eager
    rng = np.random.default_rng(2)
    calls = [[rng.integers(0, cfg.vocab_size, n).astype(np.int32)
              for n in lens] for lens in ((5, 9), (7, 3, 12), (6, 8), (20,))]
    for streams in calls:
        launches = []
        drafts = []
        for d in (dr, eager):
            kernels.reset_launches()
            drafts.append(d.propose(streams, [0] * len(streams), 3))
            torch.cuda.synchronize()
            launches.append(dict(kernels.LAUNCHES))
        for a, b in zip(*drafts):
            np.testing.assert_array_equal(a, b)
        assert launches[0] == launches[1]
        assert launches[0]["crossbar_matmul"] == 3 * 7 * cfg.n_layers
        assert launches[0]["flash_attention"] == 3 * cfg.n_layers
    # signatures (16, 3) three times and (8, 3) once: two graphs
    assert len(dr._graphs) == 2 and dr.replays == 2 and not eager._graphs
    assert dr.stats()["draft_compiles"] == 2
    assert {qt.bits for qt in (dr.qparams["layers"][0]["attn"]["wq"],
                               dr.qparams["layers"][0]["ff"]["w1"])} == {4}


# ---------------------------------------------------------------------------
# the grouped crossbar kernel (a mixture-of-experts layer's expert products)
# ---------------------------------------------------------------------------

# rows per slot: spread with empty slots, one slot full, every slot empty
GROUPED_COUNTS = {"spread": [3, 0, 17, 1, 0, 64, 9, 2],
                  "one_full": [0, 0, 0, 0, 0, 96, 0, 0],
                  "all_empty": [0] * 8}


def _grouped_inputs(dev, K, N, bits, counts, kernel, seed):
    """A (slots, K, N) stack, its grouped buffer for ``counts`` (padding
    rows hold data too: nothing of them may reach the result), bases and
    counts on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    slots = len(counts)
    qt = quant.quantize(torch.randn(slots, K, N, generator=g, device=dev)
                        * K ** -0.5, bits)
    tile = cb_ops.GROUPED_TILE[kernel]
    c = torch.tensor(counts, dtype=torch.int32, device=dev)
    bases = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                       torch.cumsum((c + tile - 1) // tile * tile, 0)
                       .to(torch.int32)])
    R = cb_ops.grouped_rows(max(sum(counts), 1), slots, tile)
    x = torch.randn(R, K, generator=g, device=dev)
    return x, qt, bases, c


def _live_rows(bases, counts, R):
    live = torch.zeros(R, dtype=torch.bool)
    for b, c in zip(bases.tolist(), counts.tolist()):
        live[b:b + c] = True
    return live


@pytest.mark.gpu
@pytest.mark.parametrize("dist", sorted(GROUPED_COUNTS))
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kn", [(256, 384), (640, 1000)])
def test_grouped_kernel_matches_plain(kn, bits, kernel, dist):
    """Every live row within crossbar's tolerance of the plain version;
    every other row exactly 0 (padding, empty slots, rows past the last
    slot), whatever the buffer held there."""
    dev = _cuda_or_skip()
    x, qt, bases, counts = _grouped_inputs(dev, *kn, bits,
                                           GROUPED_COUNTS[dist], kernel,
                                           sum(kn) + bits)
    before = kernels.LAUNCHES["grouped_crossbar_matmul"]
    y = cb_ops.grouped_crossbar_matmul(x, qt, bases, counts, kernel)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["grouped_crossbar_matmul"] == before + 1
    yr = cb_ops.grouped_crossbar_matmul_plain(x, qt, bases, counts)
    torch.testing.assert_close(y, yr, rtol=1e-4,
                               atol=1e-4 * max(float(yr.abs().max()), 1e-30))
    dead = ~_live_rows(bases, counts, x.shape[0]).to(dev)
    assert bool((y[dead] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_grouped_kernel_at_llama4_scout_width(kernel):
    """llama4-scout's expert stack (16 slots of (5120, 8192) in int8): 8
    decode rows on 8 distinct experts, or 1024 rows over the experts."""
    dev = _cuda_or_skip()
    counts = ([1] * 8 + [0] * 8 if kernel == "decode"
              else [64, 100, 0, 30, 64, 64, 90, 38, 64, 64, 64, 64, 94, 64,
                    64, 96])
    x, qt, bases, c = _grouped_inputs(dev, 5120, 8192, 8, counts, kernel, 7)
    y = cb_ops.grouped_crossbar_matmul(x, qt, bases, c, kernel)
    yr = cb_ops.grouped_crossbar_matmul_plain(x, qt, bases, c)
    torch.cuda.synchronize()
    assert float((y - yr).abs().max()) <= 1e-4 * float(yr.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_grouped_kernel_replays_in_a_graph_for_new_counts(kernel):
    """Captured once in a CUDA graph, replayed after the counts and bases
    (and x) change in place: each replay gives the plain version of its
    own routing, with every row past a count 0."""
    dev = _cuda_or_skip()
    K, N = 256, 384
    x, qt, bases, counts = _grouped_inputs(
        dev, K, N, 8, GROUPED_COUNTS["spread"], kernel, 3)
    # warm up: the eager call sizes the workspace before the capture
    cb_ops.grouped_crossbar_matmul(x, qt, bases, counts, kernel)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = cb_ops.grouped_crossbar_matmul(x, qt, bases, counts, kernel)
    tile = cb_ops.GROUPED_TILE[kernel]
    for new in ([5, 5, 5, 5, 5, 5, 5, 5], [0, 0, 96, 0, 0, 0, 0, 0],
                [1, 2, 3, 4, 0, 0, 0, 0], [0] * 8):
        c = torch.tensor(new, dtype=torch.int32, device=dev)
        b = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                       torch.cumsum((c + tile - 1) // tile * tile, 0)
                       .to(torch.int32)])
        assert int(b[-1]) <= x.shape[0]
        counts.copy_(c)
        bases.copy_(b)
        x.copy_(torch.randn_like(x))
        graph.replay()
        torch.cuda.synchronize()
        yr = cb_ops.grouped_crossbar_matmul_plain(x, qt, b, c)
        torch.testing.assert_close(
            y, yr, rtol=1e-4, atol=1e-4 * max(float(yr.abs().max()), 1e-30))
        assert bool((y[~_live_rows(b, c, x.shape[0]).to(dev)] == 0).all())


@pytest.mark.gpu
def test_grouped_kernel_has_no_backward_and_refuses_bad_layouts():
    dev = _cuda_or_skip()
    x, qt, bases, counts = _grouped_inputs(dev, 256, 128, 8, [3, 4], "decode",
                                           0)
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="item 26"):
        cb_ops.grouped_crossbar_matmul(x, qt, bases, counts, "decode")
    with torch.no_grad():
        cb_ops.grouped_crossbar_matmul(x, qt, bases, counts, "decode")
    with pytest.raises(ValueError, match="multiple of 64"):
        cb_ops.grouped_crossbar_matmul(x.detach(), qt, bases, counts,
                                       "prefill")
    with pytest.raises(TypeError):
        cb_ops.grouped_crossbar_matmul(x.detach(), qt, bases.long(), counts,
                                       "decode")


# rows per slot of the grouped decode kernel's work list at 16 slots: 8
# rows on 8 slots, 8 rows on one slot, 8 tokens top-2 (16 rows on
# distinct pairs of slots), 64 rows on 3 slots (several row groups a slot)
DECODE_DISTS = {"decode_spread": [1, 0, 1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 0, 0,
                                  1, 0],
                "decode_one": [0] * 8 + [8] + [0] * 7,
                "decode_top2": [2, 1, 0, 1, 1, 2, 1, 0, 1, 2, 1, 1, 1, 0, 1,
                                1],
                "decode_deep": [0, 30, 0, 0, 20, 0, 0, 0, 0, 0, 14, 0, 0, 0,
                                0, 0]}


@pytest.mark.gpu
@pytest.mark.parametrize("dist", sorted(DECODE_DISTS))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kn", [(2048, 1024), (640, 1000)])
def test_grouped_decode_work_list_matches_plain(kn, bits, dist):
    """The grouped decode kernel (a fixed grid over the work list of live
    row groups) at each routing of a decode tick, against the plain
    version: live rows within 1e-4, every other row exactly 0, the K split
    sized from the live row groups (several splits on one slot, one on
    eight), and two calls giving the same bits."""
    dev = _cuda_or_skip()
    counts = DECODE_DISTS[dist]
    x, qt, bases, c = _grouped_inputs(dev, *kn, bits, counts, "decode",
                                      len(dist) + bits)
    # a buffer as the MoE layer sizes it: padding rows past the last slot
    R = cb_ops.grouped_rows(sum(counts), len(counts), 8)
    x = torch.randn(R, kn[0], device=dev)
    y = cb_ops.grouped_crossbar_matmul(x, qt, bases, c, "decode")
    y2 = cb_ops.grouped_crossbar_matmul(x, qt, bases, c, "decode")
    yr = cb_ops.grouped_crossbar_matmul_plain(x, qt, bases, c)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yr, rtol=1e-4,
                               atol=1e-4 * max(float(yr.abs().max()), 1e-30))
    assert bool((y[~_live_rows(bases, c, R).to(dev)] == 0).all())
    assert torch.equal(y, y2)
    units = cb_ops.grouped_decode_work_list(
        counts, bases.tolist(), qt.codes.shape[-2] * (2 if bits == 4 else 1),
        qt.codes.shape[-1], cb_ops.grouped_decode_grid(
            torch.cuda.get_device_properties(dev).multi_processor_count))
    assert dist != "decode_one" or units[0]["S"] > 1


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_grouped_decode_graph_replays_new_counts_as_eager(bits):
    """Captured once, replayed after counts and bases change in place
    (one slot, eight, a deep slot, none: the number of live row groups and
    so the K split change): each replay gives the eager call's bits."""
    dev = _cuda_or_skip()
    K, N = 2048, 1024
    x, qt, bases, counts = _grouped_inputs(dev, K, N, bits,
                                           DECODE_DISTS["decode_spread"],
                                           "decode", 5)
    R = cb_ops.grouped_rows(64, 16, 8)
    x = torch.randn(R, K, device=dev)
    cb_ops.grouped_crossbar_matmul(x, qt, bases, counts, "decode")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = cb_ops.grouped_crossbar_matmul(x, qt, bases, counts, "decode")
    for dist in ("decode_one", "decode_deep", "decode_top2", "empty"):
        new = DECODE_DISTS.get(dist, [0] * 16)
        c = torch.tensor(new, dtype=torch.int32, device=dev)
        b = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                       torch.cumsum((c + 7) // 8 * 8, 0).to(torch.int32)])
        counts.copy_(c)
        bases.copy_(b)
        x.copy_(torch.randn_like(x))
        graph.replay()
        eager = cb_ops.grouped_crossbar_matmul(x, qt, bases, counts,
                                               "decode")
        torch.cuda.synchronize()
        assert torch.equal(y, eager), dist
        yr = cb_ops.grouped_crossbar_matmul_plain(x, qt, b, c)
        torch.testing.assert_close(
            y, yr, rtol=1e-4, atol=1e-4 * max(float(yr.abs().max()), 1e-30))


# (label, E, top_k, tpe, norm, tokens, d, masked): llama4-scout's,
# mixtral's and jamba's routers at a decode tick (8 tokens) and a mixed
# tick (1024), reduced widths, two slots an expert, a ragged mask
ROUTE_CASES = [("llama4_decode", 16, 1, 1, False, 8, 5120, False),
               ("llama4_mixed", 16, 1, 1, False, 1024, 5120, True),
               ("mixtral_decode", 8, 2, 1, True, 8, 6144, False),
               ("jamba_mixed", 16, 2, 1, True, 1024, 8192, True),
               ("tpe2_ragged", 4, 2, 2, True, 37, 70, True)]


def _route_inputs(dev, E, n, d, masked, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn(n, E, generator=g, device=dev) * 2.0
    x = torch.randn(n, d, generator=g, device=dev)
    mask = None
    if masked:
        mask = torch.rand(n, generator=g, device=dev) > 0.2
    return logits, mask, x


@pytest.mark.gpu
@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_moe_route_and_combine_match_plain(case):
    """moe_route against its plain version on the card (ids where the
    margin is >= 1e-5, rows, bases, counts and buffer rows bit-equal, the
    rest within 1e-6), then moe_combine over a random expert output with a
    shared expert's rows and without, within 1e-6; two calls of each give
    the same bits; one launch each."""
    from repro_torch.kernels.moe_route import ops as moe_ops
    dev = _cuda_or_skip()
    _, E, k, tpe, norm, n, d, masked = case
    logits, mask, x = _route_inputs(dev, E, n, d, masked, n + E)
    kw = dict(top_k=k, tpe=tpe, norm_topk=norm, tile=8,
              R=cb_ops.grouped_rows(n * k * tpe, E * tpe, 8))
    before = dict(kernels.LAUNCHES)
    got = moe_ops.moe_route(logits, mask, x, **kw)
    again = moe_ops.moe_route(logits, mask, x, **kw)
    want = moe_ops.moe_route_plain(logits, mask, x, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["moe_route"] == before["moe_route"] + 2
    check = moe_ops.compare_routes(got, want)
    assert check["ok"] and check["layout_equal"], check
    kept = want.weights > 0
    for a, b in zip(got, again):
        if a is got.xbuf:
            assert torch.equal(a[want.rows[kept]], b[want.rows[kept]])
        else:
            assert torch.equal(a, b)
    out = torch.randn(kw["R"], d, device=dev)
    for shared in (None, torch.randn(n, d, device=dev)):
        rows, w = want.rows.reshape(n, -1), want.weights.reshape(n, -1)
        y = moe_ops.moe_combine(out, rows, w, shared)
        y2 = moe_ops.moe_combine(out, rows, w, shared)
        yr = moe_ops.moe_combine_plain(out, rows, w, shared)
        torch.cuda.synchronize()
        assert torch.equal(y, y2)
        assert float((y - yr).abs().max()) <= 1e-6 * float(yr.abs().max())
    assert kernels.LAUNCHES["moe_combine"] == before["moe_combine"] + 4


def _moe_layer(dev, arch="llama4-scout-17b-a16e", bits=8, seed=0):
    """One MoE layer of a reduced config on the card, its expert stacks
    quantized (the router stays f32)."""
    from repro_torch.models import moe
    cfg = reduce_config(get_config(arch))
    g = torch.Generator(device=dev).manual_seed(seed)
    p = moe.init_moe(cfg, g, device=dev, dtype=torch.float32)
    for name in ("w1", "w2", "w3"):
        if name in p:
            p[name] = quant.quantize(p[name], bits)
    return cfg, p


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "mixtral-8x22b",
                                  "jamba-1.5-large-398b"])
def test_apply_moe_graph_replays_new_routing_as_eager(arch):
    """A whole dropless MoE layer on the kernels (moe_route, the grouped
    products, moe_combine; no host read), captured in a CUDA graph and
    replayed on new tokens: each replay equals the eager layer's bits and
    the plain layer (CPU tensors' path, on the card's weights) within
    1e-4; the capture ran one launch of each kernel."""
    from repro_torch.models import moe
    dev = _cuda_or_skip()
    cfg, p = _moe_layer(dev, arch)
    B, T = 8, 1
    x = torch.randn(B, T, cfg.d_model, device=dev)
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    kw = dict(dispatch="dropless", token_mask=mask)
    moe.apply_moe(cfg, p, x, **kw)
    torch.cuda.synchronize()
    kernels.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, aux = moe.apply_moe(cfg, p, x, **kw)
    launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
    n_stacks = 3 if cfg.mlp.startswith("gated") else 2
    assert launched["moe_route"] == launched["moe_combine"] == 1
    assert launched["grouped_crossbar_matmul"] == n_stacks
    p_cpu = _to_cpu(p)
    for seed in range(3):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x.copy_(torch.randn(x.shape, generator=gen, device=dev))
        mask.copy_(torch.rand(B, T, generator=gen, device=dev) > 0.25)
        graph.replay()
        ye, auxe = moe.apply_moe(cfg, p, x, **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, ye) and torch.equal(aux["lb_loss"],
                                                  auxe["lb_loss"])
        yp, _ = moe.apply_moe(cfg, p_cpu, x.cpu(), dispatch="dropless",
                              token_mask=mask.cpu())
        _close_rel_max([y.cpu()], [yp])


@pytest.mark.gpu
def test_moe_kernels_refuse_what_they_do_not_take():
    """Wrong dtype or device, non-contiguous inputs, a gradient: each
    raises; capacity dispatch takes neither kernel."""
    from repro_torch.kernels.moe_route import ops as moe_ops
    from repro_torch.models import moe
    dev = _cuda_or_skip()
    logits, mask, x = _route_inputs(dev, 16, 8, 256, True, 0)
    kw = dict(top_k=2, tpe=1, norm_topk=True, tile=8, R=128)
    with pytest.raises(TypeError):
        moe_ops.moe_route(logits.double(), mask, x, **kw)
    with pytest.raises(TypeError):
        moe_ops.moe_route(logits, mask.to(torch.uint8), x, **kw)
    with pytest.raises(ValueError):
        moe_ops.moe_route(logits, mask, x.cpu(), **kw)
    with pytest.raises(ValueError):
        moe_ops.moe_route(logits.t().contiguous().t(), mask, x, **kw)
    with pytest.raises(ValueError):
        moe_ops.moe_route(logits, mask, x, **{**kw, "tpe": 16})
    with pytest.raises(NotImplementedError, match="item 26"):
        moe_ops.moe_route(logits, mask, x.requires_grad_(True), **kw)
    r = moe_ops.moe_route(logits, mask, x.detach(), **kw)
    out = torch.randn(128, 256, device=dev)
    rows, w = r.rows.reshape(8, 2), r.weights.reshape(8, 2)
    with pytest.raises(TypeError):
        moe_ops.moe_combine(out, rows.int(), w, None)
    with pytest.raises(ValueError):
        moe_ops.moe_combine(out[:, ::2], rows, w[:, :2], None)
    with pytest.raises(ValueError):
        moe_ops.moe_combine(out, rows, w, torch.randn(8, 256))
    with pytest.raises(NotImplementedError, match="item 26"):
        moe_ops.moe_combine(out.requires_grad_(True), rows, w, None)
    cfg, p = _moe_layer(dev)
    kernels.reset_launches()
    with torch.no_grad():
        moe.apply_moe(cfg, p, torch.randn(2, 8, cfg.d_model, device=dev),
                      dispatch="capacity")
    assert kernels.LAUNCHES["moe_route"] == kernels.LAUNCHES[
        "moe_combine"] == 0
    assert kernels.LAUNCHES["grouped_crossbar_matmul"] > 0


# ---------------------------------------------------------------------------
# the selective scan (jamba's Mamba layers)
# ---------------------------------------------------------------------------

# (B, T, chunk_lens): decode on 8 slots, a prefill chunk of 128 on 8 slots
# (ragged as the engine masks it, one row idle), a 512-token prompt; the
# n-gram verify tick (T = 5), a T that is no multiple of any tile, a
# 4096-token prompt as the dense engine prefills it whole, and a ragged
# chunk of that T with an idle row
SCAN_CASES = [(8, 1, None), (8, 128, None),
              (8, 128, (128, 100, 64, 1, 0, 128, 37, 5)), (1, 512, None),
              (8, 5, None), (2, 300, None), (1, 4096, None),
              (4, 300, (300, 217, 0, 1))]


def _scan_inputs(dev, B, T, D, N, seed, clens=None, strided=True):
    """jamba's scan inputs: dt = softplus(x + dt_bias) as the block makes
    it (masked to 0 past each row's length), B and C as views of one
    projection's output (its strides), A = -exp(log(1..N)) per channel."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, D, generator=g, device=dev) - 4.0)
    if clens is not None:
        valid = (torch.arange(T, device=dev)[None]
                 < torch.tensor(clens, device=dev)[:, None])
        dt = dt * valid[..., None]
    xi = torch.randn(B, T, D, generator=g, device=dev)
    if strided:
        dbc = torch.randn(B, T, 32 + 2 * N, generator=g, device=dev)
        Bc, Cc = dbc[..., 32:32 + N], dbc[..., 32 + N:]
    else:
        Bc, Cc = (torch.randn(B, T, N, generator=g, device=dev)
                  for _ in range(2))
    A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(
        D, N).contiguous() * torch.rand(D, 1, generator=g, device=dev)
    h0 = torch.randn(B, D, N, generator=g, device=dev)
    return dt, Bc, Cc, xi, A, h0


def _scan_close(y, h, y_plain, h_plain):
    for got, want in ((y, y_plain), (h, h_plain)):
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,clens", SCAN_CASES)
def test_selective_scan_kernel_matches_plain_at_jamba_width(B, T, clens):
    """D = 16384 channels of 16 states (jamba's d_in and d_state), a
    nonzero carried state: one launch, the plain version's result, the
    same bits twice; a row of length 0 keeps its state."""
    dev = _cuda_or_skip()
    args = _scan_inputs(dev, B, T, 16384, 16, seed=B + T, clens=clens)
    before = kernels.LAUNCHES["selective_scan"]
    y, h = scan_ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selective_scan"] == before + 1
    y_plain, h_plain = scan_ops.selective_scan_plain(*args)
    _scan_close(y, h, y_plain, h_plain)
    y2, h2 = scan_ops.selective_scan(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    if clens is not None:
        i = clens.index(0)
        assert torch.equal(h[i], args[5][i])


@pytest.mark.gpu
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("D,strided", [(100, True), (4096, False),
                                       (70, True)])
@pytest.mark.parametrize("B", [2, 300])
def test_selective_scan_kernel_at_every_state_width(N, D, strided, B):
    """Each instantiated d_state (the reduced configs' 4, jamba's 16), a D
    that is not a multiple of a block's channels (70: nor of 4, so the
    tiled kernel copies dt and x 4 bytes at a time), contiguous and
    strided B/C, a T past one tile of steps; 2 rows (the tiled kernel's
    few-block lanes) and 300 (a block an SM or more)."""
    dev = _cuda_or_skip()
    args = _scan_inputs(dev, B, 70, D, N, seed=N + D + B, strided=strided)
    y, h = scan_ops.selective_scan(*args)
    _scan_close(y, h, *scan_ops.selective_scan_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [scan_ops.CHUNK_MIN_T - 1, scan_ops.CHUNK_MIN_T,
                               37])
def test_selective_scan_both_kernels_agree_around_the_crossover(T):
    """The register and the tiled kernel, each forced, and the one "auto"
    picks, at T on both sides of ``CHUNK_MIN_T``: each within 1e-5 of the
    plain version; a carried state 4 bytes past a 16-byte boundary, and
    B/C rows 4 bytes past one with a row stride of N + 1 (the tiled
    kernel's 4-byte paths), give the same bits as aligned ones."""
    dev = _cuda_or_skip()
    args = _scan_inputs(dev, 8, T, 4096, 16, seed=T)
    dt, Bc, Cc, xi, A, h0 = args
    want = scan_ops.selective_scan_plain(*args)
    buf = torch.empty(h0.numel() + 1, device=dev)
    buf[1:].copy_(h0.flatten())
    h0_odd = buf[1:].view(h0.shape)
    rows = torch.empty(2, 8, T, 17, device=dev)
    rows[0, ..., 1:].copy_(Bc)
    rows[1, ..., 1:].copy_(Cc)
    for kernel in scan_ops.KERNELS:
        before = kernels.LAUNCHES["selective_scan"]
        y, h = scan_ops.selective_scan(*args, kernel=kernel)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["selective_scan"] == before + 1
        _scan_close(y, h, *want)
        for odd in ((dt, Bc, Cc, xi, A, h0_odd),
                    (dt, rows[0, ..., 1:], rows[1, ..., 1:], xi, A, h0)):
            y2, h2 = scan_ops.selective_scan(*odd, kernel=kernel)
            assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.gpu
def test_selective_scan_raises_under_grad_and_refuses_bad_inputs():
    dev = _cuda_or_skip()
    dt, Bc, Cc, xi, A, h0 = _scan_inputs(dev, 1, 4, 64, 16, seed=0)
    with pytest.raises(NotImplementedError, match="item 28"):
        scan_ops.selective_scan(dt, Bc, Cc, xi.requires_grad_(True), A, h0)
    with torch.no_grad():
        scan_ops.selective_scan(dt, Bc, Cc, xi, A, h0)
    xi = xi.detach()
    with pytest.raises(ValueError, match="d_state"):
        scan_ops.selective_scan(dt, Bc[..., :3], Cc[..., :3], xi,
                                A[:, :3].contiguous(), h0[..., :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        scan_ops.selective_scan(dt.transpose(1, 2).contiguous().transpose(
            1, 2), Bc, Cc, xi, A, h0)
    with pytest.raises(TypeError):
        scan_ops.selective_scan(dt.double(), Bc, Cc, xi, A, h0)
    with pytest.raises(ValueError, match="kernel"):
        scan_ops.selective_scan(dt, Bc, Cc, xi, A, h0, kernel="chunk")


@pytest.mark.gpu
def test_mamba_block_replays_in_a_cuda_graph():
    """A Mamba block at jamba's width (d 8192, d_in 16384) with its M8F8
    in_proj/out_proj, a ragged chunk and a carried state, captured once in
    a CUDA graph: each replay on new inputs gives the eager block's output
    and state, and launches the crossbar kernel twice and the scan once."""
    dev = _cuda_or_skip()
    cfg = get_config("jamba-1.5-large-398b")
    g = torch.Generator(device=dev).manual_seed(0)
    p = ssm.init_mamba(cfg, g, device=dev, dtype=torch.float32)
    p = quant.quantize_params(p, QuantConfig(8, 8))
    assert quant.is_quantized(p["in_proj"]) and not quant.is_quantized(
        p["x_proj"])
    B, T = 8, 16
    d_in = 2 * cfg.d_model
    x = torch.randn(B, T, cfg.d_model, generator=g, device=dev)
    clens = torch.tensor([16, 9, 0, 1, 16, 3, 5, 16], dtype=torch.int32,
                         device=dev)
    cache = {"conv": torch.randn(B, 3, d_in, generator=g, device=dev),
             "ssm": torch.randn(B, d_in, 16, generator=g, device=dev)}
    cb_ops.reserve_workspace(dev, [p["in_proj"], p["out_proj"]], [B * T])

    def block():
        return ssm.apply_mamba_block(cfg, p, x, cache=cache,
                                     chunk_lens=clens)

    block()                                     # warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, newc = block()
    for seed in (1, 2):
        gs = torch.Generator(device=dev).manual_seed(seed)
        x.copy_(torch.randn(x.shape, generator=gs, device=dev))
        cache["ssm"].copy_(torch.randn(cache["ssm"].shape, generator=gs,
                                       device=dev))
        before = dict(kernels.LAUNCHES)
        want_y, want_c = block()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["selective_scan"] == before[
            "selective_scan"] + 1
        assert kernels.LAUNCHES["crossbar_matmul"] == before[
            "crossbar_matmul"] + 2
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want_y)
        for name in ssm.SLOT_STATE_LEAVES:
            assert torch.equal(newc[name], want_c[name])
        assert torch.equal(newc["ssm"][2], cache["ssm"][2])
