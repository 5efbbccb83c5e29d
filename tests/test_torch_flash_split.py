"""The arithmetic of the flash attention CUDA kernels, emulated in plain
PyTorch on the CPU and held against ``flash_attention_plain``.

Both kernels run q.k and p.v on TF32 tensor cores in 3xTF32: every f32
operand x becomes big = x rounded to TF32 (10 mantissa bits, ties away
from zero) and small = x - big (exact in f32) truncated to TF32, and each
product is small.big + big.small + big.big in f32. The emulation follows
the kernels: keys in tiles (64 at prefill, 32 at decode), only the tiles
that hold a key some row may see, an online softmax over the tiles, and a
split-KV combine that weighs each split's (m, l, acc) in split order (a
split that saw no key has l = 0 and weighs 0). It must stay within the
kernels' tolerance, 2e-5, at the served shapes (heads cut to keep the CPU
run short) for N(0, 1) inputs, a peaked softmax (q x 4), softcap and a
window. One TF32 piece must not: the test can tell the schemes apart.
At head_dim 256 the kernels take 32-key tiles (8 at decode) and read q
from shared memory (the same pieces); the ring entry point reads its keys
from two sources, the ring's W slots and then the chunk's own keys, with
positions it computes itself: both are emulated against
``ring_flash_attention_plain``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

torch.set_num_threads(2)

FA_TOL = 2e-5          # as for the kernels on the card
NEG_INF = -1e30


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Nearest TF32, ties away from zero (as cvt.rna.tf32.f32)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def pieces_of(x: torch.Tensor, pieces: int):
    big = tf32_round(x)
    return [big] if pieces == 1 else [big, tf32_trunc(x - big)]


def product(a: torch.Tensor, b: torch.Tensor, pieces: int) -> torch.Tensor:
    """a @ b as the tensor cores compute it: 3xTF32 (or one piece)."""
    ap, bp = pieces_of(a, pieces), pieces_of(b, pieces)
    if pieces == 1:
        return ap[0] @ bp[0]
    return ap[1] @ bp[0] + ap[0] @ bp[1] + ap[0] @ bp[0]


def emulate(q, k, v, q_pos, kv_pos, *, window=None, softcap=None, pieces=2,
            kt=64, splits=1, skip=True):
    """The kernels' arithmetic for q (B, T, Hq, D), k/v (B, S, Hkv, D)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    # rows R = t * G + g of each (b, kv head)
    qr = q.reshape(B, T, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, T * G, D) * (D ** -0.5)
    qp = q_pos.repeat_interleave(G, dim=1)                    # (B, T*G)
    out = torch.zeros(B, Hkv, T * G, D)
    n_tiles = -(-S // kt)
    for b in range(B):
        lo = 0 if window is None else max(0, int(qp[b].min()) - window + 1)
        hi = int(qp[b].max())
        live = [i for i in range(n_tiles)
                if not skip or bool(((kv_pos[b, i * kt:(i + 1) * kt] >= lo)
                                     & (kv_pos[b, i * kt:(i + 1) * kt]
                                        <= hi)).any())]
        for h in range(Hkv):
            parts = []
            for j in range(splits):
                mine = live[len(live) * j // splits:
                            len(live) * (j + 1) // splits]
                m = torch.full((T * G,), NEG_INF)
                l = torch.zeros(T * G)
                acc = torch.zeros(T * G, D)
                for tile in mine:
                    keys = slice(tile * kt, (tile + 1) * kt)
                    s = product(qr[b, h], k[b, keys, h].T, pieces)
                    if softcap is not None:
                        s = softcap * torch.tanh(s / softcap)
                    kp = kv_pos[b, keys]
                    vis = (kp[None] >= 0) & (kp[None] <= qp[b][:, None])
                    if window is not None:
                        vis &= (qp[b][:, None] - kp[None]) < window
                    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
                    m_new = torch.maximum(m, s.amax(dim=1))
                    corr = torch.exp(m - m_new)
                    p = torch.where(vis, torch.exp(s - m_new[:, None]),
                                    torch.zeros_like(s))
                    l = l * corr + p.sum(dim=1)
                    acc = acc * corr[:, None] + product(p, v[b, keys, h],
                                                        pieces)
                    m = m_new
                parts.append((m, l, acc))
            if splits == 1:
                m, l, acc = parts[0]
                out[b, h] = acc / l.clamp_min(1e-30)[:, None]
                continue
            ms = torch.stack([p[0] for p in parts])           # (splits, rows)
            ls = torch.stack([p[1] for p in parts])
            M = torch.where(ls > 0, ms, torch.full_like(ms, NEG_INF)).amax(0)
            w = torch.where(ls > 0, torch.exp(ms - M), torch.zeros_like(ms))
            L = (ls * w).sum(0)
            total = torch.zeros(T * G, D)
            for j in range(splits):                           # split order
                total = total + parts[j][2] * w[j][:, None]
            out[b, h] = total / L.clamp_min(1e-30)[:, None]
    return out.reshape(B, Hkv, T, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, T, Hq, D)


def _inputs(B, T, S, Hq, Hkv, D, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32) * q_scale
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(S - T, S)[None], (B, T)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (q, k, v, qpos, kpos)]


# (label, B, T, S, Hq, Hkv, kt, splits): causal prefill with GQA 4 (heads
# cut from llama3.2-1b's 32/8), and decode over 1024 keys split 4 and 8 ways
CASES = [("prefill", 1, 512, 512, 8, 2, 64, 1),
         ("decode_split4", 2, 1, 1024, 8, 2, 32, 4),
         ("decode_split8", 2, 1, 1024, 8, 2, 32, 8)]
FLAGS = [(None, None), (None, 20.0), (16, None)]


@pytest.mark.parametrize("q_scale", [1.0, 4.0])
@pytest.mark.parametrize("window,softcap", FLAGS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_3xtf32_meets_the_kernel_tolerance(case, window, softcap, q_scale):
    _, B, T, S, Hq, Hkv, kt, splits = case
    q, k, v, qpos, kpos = _inputs(B, T, S, Hq, Hkv, 64, S + splits, q_scale)
    o_plain = fa_ops.flash_attention_plain(q, k, v, qpos, kpos,
                                           window=window, softcap=softcap)
    o = emulate(q, k, v, qpos, kpos, window=window, softcap=softcap, kt=kt,
                splits=splits)
    assert float((o - o_plain).abs().max()) <= FA_TOL


@pytest.mark.parametrize("case", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_one_tf32_piece_breaks_the_kernel_tolerance(case):
    _, B, T, S, Hq, Hkv, kt, splits = case
    q, k, v, qpos, kpos = _inputs(B, T, S, Hq, Hkv, 64, 3)
    o_plain = fa_ops.flash_attention_plain(q, k, v, qpos, kpos)
    err1 = float((emulate(q, k, v, qpos, kpos, pieces=1, kt=kt,
                          splits=splits) - o_plain).abs().max())
    err3 = float((emulate(q, k, v, qpos, kpos, kt=kt, splits=splits)
                  - o_plain).abs().max())
    assert err1 > FA_TOL >= err3


@pytest.mark.parametrize("skip", [True, False])
def test_splits_that_see_no_key_weigh_nothing(skip):
    """Decode rows that see only the first 100 of 1024 keys, split 8 ways:
    with tile skipping most splits get no tile, without it most get tiles
    whose every key is masked. Either way they must weigh 0, and a row
    that sees no key at all gives 0."""
    B, T, S, Hq, Hkv = 2, 1, 1024, 8, 2
    q, k, v, qpos, kpos = _inputs(B, T, S, Hq, Hkv, 64, 5)
    qpos = torch.tensor([[99], [-1]], dtype=torch.int32)   # row 1 sees none
    o_plain = fa_ops.flash_attention_plain(q, k, v, qpos, kpos)
    o = emulate(q, k, v, qpos, kpos, kt=32, splits=8, skip=skip)
    assert float((o - o_plain).abs().max()) <= FA_TOL
    assert torch.all(o[1] == 0.0) and torch.all(o_plain[1] == 0.0)


def test_pieces_carry_f32():
    """big + small is x to within 2^-21 |x|; big alone to within 2^-11."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(
        -3, 3, 4096)).astype(np.float32))
    big, small = pieces_of(x, 2)
    rel = lambda r: float((r.abs() / x.double().abs()).max())  # noqa: E731
    assert rel(x.double() - big.double()) <= 2.0 ** -11
    assert rel(x.double() - big.double() - small.double()) <= 2.0 ** -21
    # both pieces are TF32: the low 13 bits are zero
    for p in (big, small):
        assert int((p.view(torch.int32) & 0x1FFF).abs().max()) == 0


# head_dim 256 (gemma2): 32-key tiles at prefill, 8-key tiles split over
# blocks at decode, GQA 2 (heads cut from 16/8)
D256_CASES = [("prefill", 1, 128, 128, 4, 2, 32, 1),
              ("decode_split4", 2, 1, 512, 4, 2, 8, 4)]


@pytest.mark.parametrize("case", D256_CASES, ids=[c[0] for c in D256_CASES])
def test_d256_tiles_meet_the_kernel_tolerance(case):
    _, B, T, S, Hq, Hkv, kt, splits = case
    q, k, v, qpos, kpos = _inputs(B, T, S, Hq, Hkv, 256, S, 2.0)
    kw = dict(window=96, softcap=50.0)
    o_plain = fa_ops.flash_attention_plain(q, k, v, qpos, kpos, **kw)
    o = emulate(q, k, v, qpos, kpos, kt=kt, splits=splits, **kw)
    assert float((o - o_plain).abs().max()) <= FA_TOL


def ring_key_positions(lens, chunk_lens, positions, W):
    """The ring kernel's key positions, as ``ring_pos`` computes them in
    ``csrc/flash_attention.cu`` (C's remainder truncates toward zero):
    ring slot s < W holds last - ((last - s) mod W) for last = lens - 1,
    -1 where that is negative; chunk key W + t is positions[t] for t <
    chunk_lens, else -1."""
    B, T = positions.shape
    out = np.full((B, W + T), -1, np.int64)
    for b in range(B):
        last = int(lens[b]) - 1
        for s in range(W):
            d = int(math.fmod(last - s, W))
            d += W if d < 0 else 0
            out[b, s] = max(last - d, -1)
        for t in range(int(chunk_lens[b])):
            out[b, W + t] = int(positions[b, t])
    return torch.from_numpy(out)


# (label, D, T, W, lens, chunk_lens, kt, splits): decode on wrapped and
# unwritten rings at head_dim 256; a chunk longer than its ring at 16
RING_CASES = [("decode_d256", 256, 1, 64, (100, 30), (1, 1), 8, 4),
              ("chunk_t_gt_w", 16, 40, 32, (5, 70), (40, 33), 64, 1)]


@pytest.mark.parametrize("case", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_ring_key_source_and_positions(case):
    """Keys s < W from the ring (B, Hkv, W, D), keys W + t from the chunk
    (B, T, Hkv, D), at the kernel's own positions: those equal
    ``ring_kv_pos`` wherever a key is visible (both negative elsewhere),
    and the emulated kernel is within the tolerance of
    ``ring_flash_attention_plain``."""
    _, D, T, W, lens, clens, kt, splits = case
    B, Hq, Hkv = len(lens), 4, 2
    rng = np.random.default_rng(W + T)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    q, kr, vr = t(B, T, Hq, D), t(B, Hkv, W, D), t(B, Hkv, W, D)
    kc, vc = t(B, T, Hkv, D), t(B, T, Hkv, D)
    lens = torch.tensor(lens, dtype=torch.int32)
    clens = torch.tensor(clens, dtype=torch.int32)
    pos = (lens[:, None] + torch.arange(T)[None]).to(torch.int32)
    kpos = ring_key_positions(lens, clens, pos, W)
    ref_pos = fa_ops.ring_kv_pos(lens, clens, pos, W)
    assert torch.equal(kpos >= 0, ref_pos >= 0)
    assert torch.equal(kpos[kpos >= 0], ref_pos[kpos >= 0])
    # the kernel's key s, from its source
    k = torch.cat([kr.transpose(1, 2), kc], dim=1)
    v = torch.cat([vr.transpose(1, 2), vc], dim=1)
    kw = dict(window=W, softcap=50.0)
    o_plain = fa_ops.ring_flash_attention_plain(q, kr, vr, kc, vc, pos, lens,
                                                clens, **kw)
    o = emulate(q, k, v, pos, kpos, kt=kt, splits=splits, **kw)
    valid = torch.arange(T)[None] < clens[:, None]
    assert float((o - o_plain).abs()[valid].max()) <= FA_TOL
