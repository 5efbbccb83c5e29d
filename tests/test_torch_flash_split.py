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




# ---------------------------------------------------------------------------
# head dims 128 and 256: ``wg_body`` (row tiles) and ``decode_body``
# ---------------------------------------------------------------------------
# Row tiles (G*T > 8 rows) run on wgmma: each tile's pieces are made once in
# shared memory (K as it lies, V transposed), q's once per block, and each
# product is small.big + big.small + big.big per k8 step; tiles are
# ``fa_ops.WG_KEYS`` keys, blocks ``fa_ops.WG_ROWS`` rows (two warpgroups:
# of 64 rows each at D = 128, of 128 columns each at D = 256, whose halves
# of q.k are added in warpgroup order), a block's live tiles split evenly
# when the row tiles leave SMs idle. Decode (G*T <= 8) runs in f32 on the CUDA cores over the work list
# that ``fa_ops.decode_work_list`` mirrors (units of ``DECODE_KEYS`` keys);
# a (slot, kv head)'s splits are combined in split order. The ring's slots
# and the chunk's keys tile apart.

def _source():
    from pathlib import Path
    return (Path(fa_ops.__file__).resolve().parents[2] / "csrc"
            / "flash_attention.cu").read_text()


def _constant(src, pattern):
    import re
    m = re.search(pattern, src)
    assert m is not None, pattern
    return [int(x) for x in m.groups()]


def test_wg_and_decode_cut_matches_the_source_and_fits_a_block():
    """The mirrors' tile keys, rows and decode constants are the source's;
    a row block's q pieces (each warpgroup's 64 rows), the four planes of a
    tile and the raw stage fit a block's 227 KB with 1 KB for alignment and
    1 KB for the static bytes; a V^T row (the tile's keys) is one swizzle
    row of 128 or 64 bytes and tiles split into whole k8 steps; the decode
    block's static arrays fit 48 KB and its padded rows times its chunk's
    keys are one value a lane."""
    src = _source()
    k256, k128 = _constant(src, r"constexpr int wg_keys\(int D\) \{ return "
                                r"D >= 256 \? (\d+) : (\d+); \}")
    (groups,) = _constant(src, r"constexpr int kWgGroups = (\d+);")
    (cs_from,) = _constant(src, r"constexpr bool wg_split_columns\(int D\) "
                                r"\{ return D >= (\d+); \}")
    (stages,) = _constant(src, r"constexpr int kWgStages = (\d+);")
    (rows,) = _constant(src, r"constexpr int kDecRows = (\d+);")
    (dkeys,) = _constant(src, r"constexpr int kDecKeys = (\d+);")
    (chunk,) = _constant(src, r"constexpr int kDecChunk = (\d+);")
    (warps,) = _constant(src, r"constexpr int kDecWarps = (\d+);")
    b256, b128 = _constant(src, r"dec_blocks_per_sm\(int D\) \{\s*return "
                                r"D >= 256 \? (\d+) : (\d+);")
    assert {128: k128, 256: k256} == fa_ops.WG_KEYS
    # warpgroups split a block's rows below cs_from and its columns from
    # there: 64 rows a warpgroup, or 64 rows in all
    assert {D: 64 if D >= cs_from else 64 * groups
            for D in (128, 256)} == fa_ops.WG_ROWS
    assert (rows, dkeys) == (fa_ops.DECODE_ROWS, fa_ops.DECODE_KEYS)
    assert {128: b128, 256: b256} == fa_ops.DECODE_BLOCKS_PER_SM
    assert rows * chunk == 32 and dkeys % chunk == 0
    for D in (128, 256):
        kt, q_sets = fa_ops.WG_KEYS[D], fa_ops.WG_ROWS[D] // 64
        plane = kt * D * 4
        total = 1024 + 2 * q_sets * 64 * D * 4 + 4 * plane + 2 * stages * plane
        assert total <= 232448 - 1024, (D, total)
        assert kt * 4 in (64, 128) and kt % 8 == 0 and D % 32 == 0
        assert (rows + warps * rows) * D * 4 + 1024 <= 48 * 1024


def _run_tiles(qr, kb, vb, kp, qp, tiles, kt, window, softcap, pieces,
               halves=False):
    """One split's (m, l, acc) over ``tiles`` of one (slot, kv head): the
    kernels' online softmax; products in 3xTF32 (pieces 2), one TF32 piece
    (1) or f32 (0: the decode kernel's FMAs); ``halves``: q.k as the sum of
    its two column halves' products, first half first (D = 256)."""
    rows, D = qr.shape
    m = torch.full((rows,), NEG_INF)
    l = torch.zeros(rows)
    acc = torch.zeros(rows, D)
    mul = (lambda a, b: a @ b) if pieces == 0 else (  # noqa: E731
        lambda a, b: product(a, b, pieces))
    for tile in tiles:
        keys = slice(tile * kt, (tile + 1) * kt)
        kpos = kp[keys]
        # keys that no row may see are 0 (the planes; the decode's loads)
        ok = (kpos >= 0)[:, None]
        kt_ = torch.where(ok, kb[keys], torch.zeros_like(kb[keys]))
        vt_ = torch.where(ok, vb[keys], torch.zeros_like(vb[keys]))
        if halves:
            c = qr.shape[1] // 2
            s = mul(qr[:, :c], kt_[:, :c].T) + mul(qr[:, c:], kt_[:, c:].T)
        else:
            s = mul(qr, kt_.T)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        vis = (kpos[None] >= 0) & (kpos[None] <= qp[:, None])
        if window is not None:
            vis &= (qp[:, None] - kpos[None]) < window
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=1))
        corr = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new[:, None]), torch.zeros_like(s))
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + mul(p, vt_)
        m = m_new
    return m, l, acc


def _combine(parts):
    """Splits' (m, l, acc) summed in split order, each weighing
    exp(m_j - M) (0 where l_j = 0)."""
    if len(parts) == 1:
        m, l, acc = parts[0]
        return acc / l.clamp_min(1e-30)[:, None]
    ms = torch.stack([p[0] for p in parts])
    ls = torch.stack([p[1] for p in parts])
    M = torch.where(ls > 0, ms, torch.full_like(ms, NEG_INF)).amax(0)
    w = torch.where(ls > 0, torch.exp(ms - M), torch.zeros_like(ms))
    total = torch.zeros_like(parts[0][2])
    for j in range(len(parts)):
        total = total + parts[j][2] * w[j][:, None]
    return total / (ls * w).sum(0).clamp_min(1e-30)[:, None]


def emulate_wg(q, k, v, q_pos, kv_pos, *, window=None, softcap=None,
               units=None, pieces=2, grid=None, n_ring_tiles=0):
    """The head-dim 128 / 256 kernels' arithmetic for q (B, T, Hq, D) over
    k/v (B, S, Hkv, D) with key positions kv_pos (-1: no key). G*T > 8:
    ``wg_body``'s row tiles (``WG_ROWS`` rows, ``WG_KEYS``-key tiles, one
    split: the shapes here leave no SM idle) in 3xTF32 (``pieces``). Else
    ``decode_body``: the work list over ``units`` (``fa_ops.slot_units`` in
    ``DECODE_KEYS``-key units, all tiles by default; a ring's units map to
    tiles past its ``n_ring_tiles``) on a grid of ``grid`` blocks, each
    item's live units in f32, the splits combined in order."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    rows = T * G
    qr = q.reshape(B, T, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, rows, D) * (D ** -0.5)
    qp = q_pos.repeat_interleave(G, dim=1)
    out = torch.zeros(B, Hkv, rows, D)

    def live(b, r0, r1, tile, kt):
        qs = qp[b, r0:r1]
        lo = 0 if window is None else max(0, int(qs.min()) - window + 1)
        kpt = kv_pos[b, tile * kt:(tile + 1) * kt]
        return bool(((kpt >= lo) & (kpt <= int(qs.max()))).any())

    if rows > fa_ops.DECODE_ROWS:
        kt, rb = fa_ops.WG_KEYS[D], fa_ops.WG_ROWS[D]
        n_tiles = -(-S // kt)
        for b in range(B):
            for h in range(Hkv):
                for r0 in range(0, rows, rb):
                    r1 = min(rows, r0 + rb)
                    tiles = [i for i in range(n_tiles)
                             if live(b, r0, r1, i, kt)]
                    part = _run_tiles(qr[b, h, r0:r1], k[b, :, h], v[b, :, h],
                                      kv_pos[b], qp[b, r0:r1], tiles, kt,
                                      window, softcap, pieces,
                                      halves=D >= 256)
                    out[b, h, r0:r1] = _combine([part])
    else:
        kt = fa_ops.DECODE_KEYS
        units = units or [(0, -(-S // kt))] * B
        items = fa_ops.decode_work_list(
            units, Hkv, grid or fa_ops.decode_grid(B, Hkv, D))
        for b in range(B):
            for h in range(Hkv):
                mine = sorted((it for it in items
                               if it["b"] == b and it["h"] == h),
                              key=lambda it: it["split"])
                parts = []
                for it in mine:
                    tiles = [fa_ops.unit_tile(x, units[b][0], n_ring_tiles)
                             for x in range(it["u0"], it["u1"])]
                    tiles = [x for x in tiles if live(b, 0, rows, x, kt)]
                    parts.append(_run_tiles(qr[b, h], k[b, :, h], v[b, :, h],
                                            kv_pos[b], qp[b], tiles, kt,
                                            window, softcap, 0))
                if parts:
                    out[b, h] = _combine(parts)
    return out.reshape(B, Hkv, T, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, T, Hq, D)


# (label, B, T, S, Hq, Hkv, D): row tiles at GQA 8 (chameleon's 64/8,
# heads cut; two blocks of 128 rows), at GQA 8 with T = 2 (16 rows: row
# tiles, not decode) and at GQA 2 (gemma2's 16/8); decode over the work
# list at GQA 5, 8 and 2
WG_CASES = [("prefill_d128_g8", 1, 40, 160, 16, 2, 128),
            ("rows16_d128_g8", 2, 2, 300, 16, 2, 128),
            ("prefill_d256_g2", 1, 48, 96, 4, 2, 256),
            ("decode_d128_g5", 3, 1, 700, 10, 2, 128),
            ("decode_d128_g8", 2, 1, 300, 16, 2, 128),
            ("decode_d256_g2", 4, 1, 500, 4, 2, 256)]


@pytest.mark.parametrize("window,softcap", [(None, None), (96, 50.0)])
@pytest.mark.parametrize("case", WG_CASES, ids=[c[0] for c in WG_CASES])
def test_wg_and_decode_meet_the_kernel_tolerance(case, window, softcap):
    _, B, T, S, Hq, Hkv, D = case
    q, k, v, qpos, kpos = _inputs(B, T, S, Hq, Hkv, D, S + T, 2.0)
    kw = dict(window=window, softcap=softcap)
    o_plain = fa_ops.flash_attention_plain(q, k, v, qpos, kpos, **kw)
    # a small grid, so that the decode rows split over many blocks
    o = emulate_wg(q, k, v, qpos, kpos, grid=24, **kw)
    assert float((o - o_plain).abs().max()) <= FA_TOL


@pytest.mark.parametrize("case", WG_CASES[:3],
                         ids=[c[0] for c in WG_CASES[:3]])
def test_wg_one_tf32_piece_breaks_the_kernel_tolerance(case):
    _, B, T, S, Hq, Hkv, D = case
    q, k, v, qpos, kpos = _inputs(B, T, S, Hq, Hkv, D, 7)
    o_plain = fa_ops.flash_attention_plain(q, k, v, qpos, kpos)
    err1 = float((emulate_wg(q, k, v, qpos, kpos, pieces=1)
                  - o_plain).abs().max())
    err3 = float((emulate_wg(q, k, v, qpos, kpos) - o_plain).abs().max())
    assert err1 > FA_TOL >= err3


def _decode_slots(kind):
    """Slots as a decode tick holds them: idle ones among live ones of
    every length (paged: pool of 320 pages of 16 a table row; ring: a ring
    of 256 that has wrapped, is filling and is empty)."""
    lens = [0, 37, 300, 0, 1, 4811, 128, 0]
    clens = [0, 1, 1, 0, 1, 1, 1, 0]
    if kind == "ring":
        lens[5], lens[1] = 9000, 200
    return lens, clens


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("kind", ["paged", "ring", "contiguous"])
def test_decode_work_list_covers_every_live_key_once(kind, D):
    """Every live key of every live (slot, kv head) lies in exactly one
    item's tiles, an idle slot gets no item, blocks are distinct and inside
    the grid, a long context gets more blocks than a short one, and the
    grid depends on the shapes only."""
    kt, B, Hkv = fa_ops.DECODE_KEYS, 8, 8
    lens, clens = _decode_slots(kind)
    W, page, nb = 256, 16, 320
    kw = ({"ring_w": W} if kind == "ring" else
          {"pool_keys": nb * page} if kind == "paged" else
          {"n_tiles": -(-5000 // kt)})
    units = fa_ops.slot_units(kt, lens, clens, **kw)
    grid = fa_ops.decode_grid(B, Hkv, D)
    assert grid % 132 == 0 and grid >= B * Hkv
    assert grid == fa_ops.decode_grid(B, Hkv, D)    # no lens in the rule
    items = fa_ops.decode_work_list(units, Hkv, grid)
    blocks = [it["block"] for it in items]
    assert len(set(blocks)) == len(blocks) and max(blocks) < grid
    n_rt = -(-W // kt) if kind == "ring" else 0
    for b in range(B):
        ur, u = units[b]
        # the contiguous entry point has no lens: every slot is read
        idle = kind != "contiguous" and lens[b] + clens[b] == 0
        assert (u == 0) == idle
        # the keys this slot may hold, by tile
        if kind == "ring":
            keys = [s // kt for s in range(min(lens[b], W))]
            keys += [n_rt + c // kt for c in range(clens[b])]
        elif kind == "paged":
            keys = [s // kt for s in range(lens[b] + clens[b])]
        else:
            keys = [s // kt for s in range(5000)]
        for h in range(Hkv):
            mine = [it for it in items if it["b"] == b and it["h"] == h]
            assert bool(mine) == (not idle)
            if idle:
                continue
            n = mine[0]["n"]
            assert [it["split"] for it in mine] == list(range(n))
            assert all(it["first"] == mine[0]["block"] for it in mine)
            tiles = [fa_ops.unit_tile(x, ur, n_rt) for it in mine
                     for x in range(it["u0"], it["u1"])]
            for tile in keys:
                assert tiles.count(tile) == 1
    if kind != "contiguous":
        n_of = {it["b"]: it["n"] for it in items}
        assert n_of[5] > n_of[1]


def test_ring_and_idle_decode_meet_the_kernel_tolerance():
    """The ring's slots and the chunk's keys tiled apart, through the
    decode work list with an idle slot, at D = 256 (gemma2's softcap and
    window)."""
    D, kt, Hq, Hkv, W = 256, fa_ops.DECODE_KEYS, 4, 2, 64
    lens = torch.tensor([100, 0, 30, 5], dtype=torch.int32)
    clens = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    B, T = 4, 1
    rng = np.random.default_rng(11)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    q, kr, vr = t(B, T, Hq, D), t(B, Hkv, W, D), t(B, Hkv, W, D)
    kc, vc = t(B, T, Hkv, D), t(B, T, Hkv, D)
    pos = (lens[:, None] + torch.arange(T)[None]).to(torch.int32)
    kw = dict(window=W, softcap=50.0)
    o_plain = fa_ops.ring_flash_attention_plain(q, kr, vr, kc, vc, pos, lens,
                                                clens, **kw)
    # the kernel's key space: ring tiles, then chunk tiles
    n_rt = -(-W // kt)
    kpos_ring = ring_key_positions(lens, clens, pos, W)
    S = (n_rt + -(-T // kt)) * kt
    k = torch.zeros(B, S, Hkv, D)
    v = torch.zeros(B, S, Hkv, D)
    kpos = torch.full((B, S), -1, dtype=torch.int64)
    k[:, :W], v[:, :W] = kr.transpose(1, 2), vr.transpose(1, 2)
    k[:, n_rt * kt:n_rt * kt + T] = kc
    v[:, n_rt * kt:n_rt * kt + T] = vc
    kpos[:, :W] = kpos_ring[:, :W]
    kpos[:, n_rt * kt:n_rt * kt + T] = kpos_ring[:, W:]
    units = fa_ops.slot_units(kt, lens.tolist(), clens.tolist(), ring_w=W)
    o = emulate_wg(q, k, v, pos, kpos, units=units, grid=24,
                   n_ring_tiles=n_rt, **kw)
    valid = torch.arange(T)[None] < clens[:, None]
    assert float((o - o_plain).abs()[valid].max()) <= FA_TOL
    assert torch.all(o[1] == 0.0)     # the idle slot: no item, no key
