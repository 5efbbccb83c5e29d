"""The arithmetic of the flash attention backward CUDA kernels, emulated in
plain PyTorch on the CPU and held against ``flash_attention_bwd_plain``.

The backward kernels run all five products (S, dP, dV += P^T dO,
dK += dS^T q, dQ += dS K) on tensor cores. Up to head dim 64 they run
3xTF32 mma.sync, as the forward (``tests/test_torch_flash_split.py`` has
the pieces and the product). From head dim 128 they run wgmma on fp16
pieces (``f16_product``): every f32 operand x, scaled by a power of two
(``scales``: q D^-1/2, dout, k and v from their largest |x|, p by 2^14,
ds from a bound), is big = fp16(x) plus small = fp16(x - big), and each
product is small.big + big.small + big.big in f32, the scales taken off
after; wgmma takes 16-bit operands MN-major, so the planes that hold q,
dout and K serve both the products that reduce over D and those that
reduce over rows (keys) without a transposed copy. Two bf16 pieces (8
bits each) would leave ~5e-5, 2x the plain version's distance from an
f64 reference at gemma2-9b's window; two fp16 pieces (11 bits) ~2e-6.
The emulation follows
the kernels tile by tile, with the tiles the source fixes for the head
dim (``tiles``: 64 stationary keys or rows and 32 streamed below 128; 128
and 32 at 128, where each of two warpgroups owns 64; 64 and 16 at 256):
the dk/dv pass takes each stationary key tile, lists the streamed query
tiles (BS rows R = t G + g of the kv head's group) that may hold a row
seeing one of its keys, splits that list over blocks of at most ``per``
tiles (``bwd_plan``), accumulates each split's dK and dV over its tiles in
order and sums the splits in split order; the dq pass does the same per
stationary row tile over its streamed key tiles. At head dim 256 the two
warpgroups sum S and dP over one half of D each and add the halves in
warpgroup order, then each accumulates dK, dV (dQ) for its half of the
columns. D^-1/2 goes where the kernels put it: up to 64 on K's fragments
and on the summed dK in the dk/dv pass, on q's fragments and the summed
dQ in the dq pass; from 128 on q before it is split (both passes) and on
the summed dQ. It must stay within the kernels' tolerance, 1e-4 relative
and absolute, at T = 512 causal with the heads cut from llama3.2-1b's
32/8 and gemma2-9b's 16/8 (their plans' cuts kept), with a window and a
softcap (gemma2's 50 at head dim 256), and with rows and keys that see
nothing. One piece must not, in either scheme: the test can tell the
schemes apart.
"""
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from test_torch_flash_split import product

torch.set_num_threads(2)

FA_BWD_TOL = 1e-4      # relative and absolute, as for the kernels on the card


def _constant(name: str) -> int:
    """One of the backward plan's constants as the kernels' source fixes it
    (the lines ``benchmarks/torch_flash_bwd_tiles.py`` rewrites), so the
    emulation follows the source when they change."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    line = re.search(rf"^constexpr int {name} = (\d+);", src, re.M)
    assert line is not None, f"no line 'constexpr int {name} = ...;'"
    return int(line.group(1))


BT = _constant("kBT")          # keys (dk/dv) or rows (dq) of a block
BS = _constant("kBS")          # rows (dk/dv) or keys (dq) of a streamed tile
WAVES = _constant("kBWaves")   # blocks for every SM that the plan aims at
MAX_ROWS = _constant("kBMaxRows")   # streamed rows a block sums, at most
# from head dim 128: consumer warpgroups (64 stationary rows each, or the
# columns of the block's 64 split between them from SPLIT_KV (dk/dv) and
# SPLIT_Q (dq)) and the streamed tiles
GROUPS_WIDE = _constant("kBWideGroups")
BS_128 = _constant("kBWideTile128")
BS_256 = _constant("kBWideTile256")
SPLIT_KV = _constant("kBSplitDkdv")
SPLIT_Q = _constant("kBSplitDq")
WAVES_WIDE_PCT = _constant("kBWavesWidePct")   # hundredths
MAX_ROWS_WIDE = _constant("kBMaxRowsWide")
H100_SMS = 132                 # the SM count the plan reads on the H100


def tiles(D, kv=True):
    """(stationary tile, streamed tile, column halves) of the dk/dv (kv)
    or the dq kernel at head dim D, as ``bwd_bt`` / ``bwd_bs`` in
    ``csrc/flash_attention.cu``; with the columns split S and dP are summed
    a half of D at a time."""
    if D < 128:
        return BT, BS, 1
    bs = BS_256 if D >= 256 else BS_128
    if D >= (SPLIT_KV if kv else SPLIT_Q):
        return 64, bs, GROUPS_WIDE
    return 64 * GROUPS_WIDE, bs, 1


def f16_pieces(x: torch.Tensor, pieces: int):
    """x as fp16 values (in f32), largest first: big = fp16(x), small =
    fp16(x - big), each rounded to nearest even (as __floats2half2_rn)."""
    out, rest = [], x
    for _ in range(pieces):
        piece = rest.to(torch.float16).to(torch.float32)
        out.append(piece)
        rest = rest - piece
    return out


def f16_product(a: torch.Tensor, b: torch.Tensor, pieces: int, sa=1.0,
                sb=1.0):
    """a @ b as the wide kernels' wgmma computes it from a sa and b sb:
    small.big + big.small + big.big of two fp16 pieces (or big.big of one),
    then / (sa sb)."""
    ap, bp = f16_pieces(a * sa, pieces), f16_pieces(b * sb, pieces)
    if pieces == 1:
        return ap[0] @ bp[0] / (sa * sb)
    return (ap[1] @ bp[0] + ap[0] @ bp[1] + ap[0] @ bp[0]) / (sa * sb)


def pow2_under(x: float, top: int) -> float:
    """2^e with x 2^e in [2^(top - 1), 2^top) (1 for 0), as the kernels'."""
    if not x > 0 or not math.isfinite(x):
        return 1.0
    e = math.frexp(x)[1] - 1                       # floor(log2 x)
    return 2.0 ** min(max(top - 1 - e, -120), 120)


def scales(q, dout, k, v, c):
    """The wide kernels' powers of two for one call (``bwd_scales``): q
    D^-1/2, dout, k, v under 2^14 from their largest |x|; p by 2^14; ds by
    its bound 2 D max|dout| max|v| under 2^14."""
    f32 = torch.float32
    mq = float(q.abs().max() * torch.tensor(c, dtype=f32))
    mdo, mk, mv = (float(x.abs().max()) for x in (dout, k, v))
    D = q.shape[-1]
    return {"q": pow2_under(mq, 14), "dout": pow2_under(mdo, 14),
            "k": pow2_under(mk, 14), "v": pow2_under(mv, 14), "p": 2.0 ** 14,
            "ds": pow2_under(float(torch.tensor(D * mdo, dtype=f32) * mv), 13)}


def scheme_of(D):
    """The pieces scheme the kernels run at head dim D."""
    return "f16" if D >= 128 else "tf32"


def bwd_plan(B, T, Hq, Hkv, S, D, sms=H100_SMS):
    """Streamed tiles per block of the dk/dv and the dq pass: about WAVES
    (WAVES_WIDE_PCT / 100 from head dim 128) blocks for every SM over a
    causal call's live tile pairs (half of them), no more than MAX_ROWS
    (MAX_ROWS_WIDE) rows (keys) a block, as ``bwd_pass`` in
    ``csrc/flash_attention.cu``."""
    rows = T * (Hq // Hkv)
    btk, bs, _ = tiles(D, True)
    btq = tiles(D, False)[0]
    pct, max_rows = ((WAVES_WIDE_PCT, MAX_ROWS_WIDE) if D >= 128
                     else (100 * WAVES, MAX_ROWS))

    def per(n_stat, n_str):
        pairs = max(1, B * Hkv * n_stat * n_str // 2)
        return min(-(-100 * pairs // (pct * sms)), max_rows // bs, n_str)

    return (per(-(-S // btk), -(-rows // bs)),
            per(-(-rows // btq), -(-S // bs)))


def split_ranges(count, per):
    """[i0, i1) of each block of a stationary tile's ``count`` live tiles."""
    splits = -(-count // per) if count > per else 1
    return [(count * r // splits, count * (r + 1) // splits)
            for r in range(splits)]


def emulate_bwd(q, k, v, q_pos, kv_pos, out, lse, dout, *, per_kv, per_q,
                window=None, softcap=None, pieces=2, scheme=None):
    """dq, dk, dv as the kernels compute them (``scheme``: "tf32" or
    "f16"; the kernels' own at the head dim by default)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G, c = Hq // Hkv, D ** -0.5
    rows = T * G
    BTK, BS, halves_kv = tiles(D, True)
    BTQ, _, halves_q = tiles(D, False)
    wide = (scheme or scheme_of(D)) == "f16"
    sc = scales(q, dout, k, v, c)

    def mul(a, x, pieces, sa=1.0, sb=1.0):
        if wide:
            return f16_product(a, x, pieces, sa, sb)
        return product(a, x, pieces)

    def group(x):                   # (B, T, Hq, ...) -> (B, Hkv, rows, ...)
        x = x.reshape(B, T, Hkv, G, *x.shape[3:]).transpose(1, 2)
        return x.reshape(B, Hkv, rows, *x.shape[4:])

    qr, dor = group(q), group(dout)
    di = group((dout * out).sum(-1))
    lr = group(lse.transpose(1, 2))
    qp = q_pos.repeat_interleave(G, dim=1)                    # (B, rows)
    dq = torch.zeros(B, Hkv, rows, D)
    dk = torch.zeros(B, S, Hkv, D)
    dv = torch.zeros(B, S, Hkv, D)

    def over_d(a, x, sa, sb, halves):   # a @ x^T, a half of D at a time
        w = D // halves
        total = mul(a[:, :w], x[:, :w].T, pieces, sa, sb)
        for i in range(1, halves):
            total = total + mul(a[:, i * w:(i + 1) * w],
                                x[:, i * w:(i + 1) * w].T, pieces, sa, sb)
        return total

    def p_ds(b, h, rs, ks, kv_pass):
        halves = halves_kv if kv_pass else halves_q
        if wide:          # q D^-1/2 split once, for both passes
            s = over_d(qr[b, h, rs] * c, k[b, ks, h], sc["q"], sc["k"], halves)
        elif kv_pass:     # the dk/dv pass scales K's fragments, the dq q's
            s = product(qr[b, h, rs], (k[b, ks, h] * c).T, pieces)
        else:
            s = product(qr[b, h, rs] * c, k[b, ks, h].T, pieces)
        dp = (over_d(dor[b, h, rs], v[b, ks, h], sc["dout"], sc["v"], halves)
              if wide else over_d(dor[b, h, rs], v[b, ks, h], 1.0, 1.0, halves))
        dcap = 1.0
        if softcap is not None:
            th = torch.tanh(s / softcap)
            s, dcap = softcap * th, 1.0 - th * th
        kp, rp = kv_pos[b, ks][None], qp[b, rs][:, None]
        vis = (kp >= 0) & (kp <= rp)
        if window is not None:
            vis &= rp - kp < window
        p = torch.where(vis, torch.exp(s - lr[b, h, rs][:, None]),
                        torch.zeros_like(s))
        return p, p * (dp - di[b, h, rs][:, None]) * dcap

    def phase2(a, x, sa=1.0, sb=1.0, halves=1):   # a @ x, a half at a time
        w = D // halves
        return torch.cat([mul(a, x[:, i * w:(i + 1) * w], pieces, sa, sb)
                          for i in range(halves)], dim=-1)

    def summed(parts):    # one split as it is; more in split order, from 0
        if len(parts) == 1:
            return parts[0]
        total = torch.zeros_like(parts[0])
        for part in parts:
            total = total + part
        return total

    for b in range(B):
        for h in range(Hkv):
            for j in range(-(-S // BTK)):                     # dk/dv pass
                ks = slice(j * BTK, (j + 1) * BTK)
                kp = kv_pos[b, ks]
                kp = kp[kp >= 0]
                live = []
                if kp.numel():
                    lo, hi = int(kp.min()), int(kp.max())
                    for i in range(-(-rows // BS)):
                        rp = qp[b, i * BS:(i + 1) * BS]
                        ok = (rp >= 0) & (rp >= lo)
                        if window is not None:
                            ok &= rp - window < hi
                        if bool(ok.any()):
                            live.append(i)
                parts = []
                for i0, i1 in split_ranges(len(live), per_kv):
                    pk = torch.zeros(k[b, ks].shape[0], D)
                    pv = torch.zeros_like(pk)
                    for i in live[i0:i1]:
                        rs = slice(i * BS, (i + 1) * BS)
                        p, ds = p_ds(b, h, rs, ks, True)
                        if wide:   # (the scales come off exactly)
                            pv = pv + phase2(p.T, dor[b, h, rs], sc["p"],
                                             sc["dout"], halves_kv)
                            pk = pk + phase2(ds.T, qr[b, h, rs] * c, sc["ds"],
                                             sc["q"], halves_kv)
                        else:
                            pv = pv + phase2(p.T, dor[b, h, rs])
                            pk = pk + phase2(ds.T, qr[b, h, rs])
                    parts.append((pk, pv))
                dk[b, ks, h] = summed([pk for pk, _ in parts]) * (
                    1.0 if wide else c)
                dv[b, ks, h] = summed([pv for _, pv in parts])
            for i in range(-(-rows // BTQ)):                  # dq pass
                rs = slice(i * BTQ, (i + 1) * BTQ)
                rp = qp[b, rs]
                rp = rp[rp >= 0]
                live = []
                if rp.numel():
                    lo, hi = int(rp.min()), int(rp.max())
                    for j in range(-(-S // BS)):
                        kp = kv_pos[b, j * BS:(j + 1) * BS]
                        ok = (kp >= 0) & (kp <= hi)
                        if window is not None:
                            ok &= kp > lo - window
                        if bool(ok.any()):
                            live.append(j)
                parts = []
                for j0, j1 in split_ranges(len(live), per_q):
                    pq = torch.zeros_like(qr[b, h, rs])
                    for j in live[j0:j1]:
                        ks = slice(j * BS, (j + 1) * BS)
                        _, ds = p_ds(b, h, rs, ks, False)
                        pq = pq + (phase2(ds, k[b, ks, h], sc["ds"], sc["k"],
                                          halves_q)
                                   if wide else phase2(ds, k[b, ks, h]))
                    parts.append(pq)
                dq[b, h, rs] = summed(parts) * c
    dq = dq.reshape(B, Hkv, T, G, D).transpose(1, 2).reshape(B, T, Hq, D)
    return dq, dk, dv


def _inputs(B, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q, dout = (torch.from_numpy(rng.standard_normal(
        (B, T, Hq, D)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (B, T, Hkv, D)).astype(np.float32)) for _ in range(2))
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T).contiguous()
    return q, k, v, pos, pos.clone(), dout


def _over(got, want):
    """How far the worst element lies past the relative part of the
    tolerance: within tolerance when <= FA_BWD_TOL (the absolute part)."""
    return max(float(((a - b).abs() - FA_BWD_TOL * b.abs()).max())
               for a, b in zip(got, want))


def _run(B, T, Hq, Hkv, q, k, v, qpos, kpos, dout, window, softcap, pieces,
         plan_of=None, scheme=None):
    out, lse = fa_ops.flash_attention_plain(q, k, v, qpos, kpos, window=window,
                                            softcap=softcap, with_lse=True)
    args = (q, k, v, qpos, kpos, out, lse, dout)
    want = fa_ops.flash_attention_bwd_plain(*args, window=window,
                                            softcap=softcap)
    per_kv, per_q = bwd_plan(*(plan_of or (B, T, Hq, Hkv, T)), q.shape[-1])
    got = emulate_bwd(*args, per_kv=per_kv, per_q=per_q, window=window,
                      softcap=softcap, pieces=pieces, scheme=scheme)
    return _over(got, want)


# T = 512 causal at llama3.2-1b's group of 4 with its heads cut to 8/2 and
# one sequence (the plan of its microbatch, B = 2 at 32/8, kept: 16 tiles
# a block, key tile 0's 64 row tiles split 4 ways), and a window with a
# softcap on the forward case's small shape; at head dim 256, gemma2-9b's
# group of 2 with its heads cut to 4/2 and the plan of its microbatch (B =
# 2 at 16/8: 16 tiles of 16 rows a block, key tile 0's 64 row tiles split
# 4 ways), causal and with a window, both with its softcap of 50; at head
# dim 128, mistral-nemo-12b's group of 4 cut to 8/2 with its plan (8 tiles
# of 32 rows a block, key tile 0's 64 row tiles split 8 ways)
CASES = [("causal", 1, 512, 8, 2, 64, None, None, (2, 512, 32, 8, 512)),
         ("window+softcap", 2, 256, 8, 2, 64, 64, 30.0, None),
         ("gemma2 causal+softcap", 1, 512, 4, 2, 256, None, 50.0,
          (2, 512, 16, 8, 512)),
         ("gemma2 window+softcap", 1, 512, 4, 2, 256, 128, 50.0,
          (2, 512, 16, 8, 512)),
         ("mistral-nemo causal", 1, 512, 8, 2, 128, None, None,
          (2, 512, 32, 8, 512))]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_3xtf32_backward_meets_the_kernel_tolerance(case):
    """The kernels' scheme at each head dim: 3xTF32 up to 64, two fp16
    pieces (three products) from 128."""
    _, B, T, Hq, Hkv, D, window, softcap, plan_of = case
    q, k, v, qpos, kpos, dout = _inputs(B, T, Hq, Hkv, D, T + Hq)
    over = _run(B, T, Hq, Hkv, q, k, v, qpos, kpos, dout, window, softcap,
                2, plan_of)
    assert over <= FA_BWD_TOL, over


def test_one_tf32_piece_breaks_the_backward_tolerance():
    _, B, T, Hq, Hkv, D, _, _, plan_of = CASES[0]
    q, k, v, qpos, kpos, dout = _inputs(B, T, Hq, Hkv, D, 5)
    args = (B, T, Hq, Hkv, q, k, v, qpos, kpos, dout, None, None)
    assert _run(*args, 1, plan_of) > FA_BWD_TOL >= _run(*args, 2, plan_of)


def test_one_tf32_piece_breaks_the_backward_tolerance_at_head_dim_256():
    """gemma2-9b's cut heads with its softcap and a window, the TF32 scheme
    on the kernels' cut at 256 (the halves of D, the 16-row tiles): they
    change nothing of the scheme's error."""
    _, B, T, Hq, Hkv, D, window, softcap, plan_of = CASES[3]
    q, k, v, qpos, kpos, dout = _inputs(B, T, Hq, Hkv, D, 6)
    args = (B, T, Hq, Hkv, q, k, v, qpos, kpos, dout, window, softcap)
    assert (_run(*args, 1, plan_of, "tf32") > FA_BWD_TOL
            >= _run(*args, 2, plan_of, "tf32"))


@pytest.mark.parametrize("case", [CASES[3], CASES[4]],
                         ids=[CASES[3][0], CASES[4][0]])
def test_one_f16_piece_breaks_the_backward_tolerance(case):
    """The wide kernels' scheme: one fp16 piece (big.big alone) leaves
    ~4e-3, two pieces in three products stay within the tolerance."""
    _, B, T, Hq, Hkv, D, window, softcap, plan_of = case
    q, k, v, qpos, kpos, dout = _inputs(B, T, Hq, Hkv, D, 7)
    args = (B, T, Hq, Hkv, q, k, v, qpos, kpos, dout, window, softcap)
    assert (_run(*args, 1, plan_of, "f16") > FA_BWD_TOL
            >= _run(*args, 2, plan_of, "f16"))


def test_rows_and_keys_that_see_nothing_give_zeros():
    """Rows at position -1 see no key and keys at -1 are seen by no row:
    their dq (dk, dv) are 0, the splits of the others unchanged. A small
    plan (one tile a block) splits every list."""
    B, T, Hq, Hkv, D = 1, 200, 4, 2, 16
    q, k, v, qpos, kpos, dout = _inputs(B, T, Hq, Hkv, D, 9)
    qpos[0, 150:] = -1
    kpos[0, :70] = -1
    out, lse = fa_ops.flash_attention_plain(q, k, v, qpos, kpos,
                                            with_lse=True)
    args = (q, k, v, qpos, kpos, out, lse, dout)
    want = fa_ops.flash_attention_bwd_plain(*args)
    got = emulate_bwd(*args, per_kv=1, per_q=1)
    assert _over(got, want) <= FA_BWD_TOL
    assert torch.all(got[0][0, 150:] == 0) and torch.all(got[1][0, :70] == 0)
    assert torch.all(got[2][0, :70] == 0)


def test_rows_and_keys_that_see_nothing_give_zeros_at_head_dim_128():
    """As above at head dim 128 (128-key tiles, 32-row streamed tiles, fp16
    pieces), every list split one tile a block."""
    B, T, Hq, Hkv, D = 1, 120, 4, 2, 128
    q, k, v, qpos, kpos, dout = _inputs(B, T, Hq, Hkv, D, 10)
    qpos[0, 90:] = -1
    kpos[0, :40] = -1
    out, lse = fa_ops.flash_attention_plain(q, k, v, qpos, kpos, softcap=50.0,
                                            with_lse=True)
    args = (q, k, v, qpos, kpos, out, lse, dout)
    want = fa_ops.flash_attention_bwd_plain(*args, softcap=50.0)
    got = emulate_bwd(*args, per_kv=1, per_q=1, softcap=50.0)
    assert _over(got, want) <= FA_BWD_TOL
    assert torch.all(got[0][0, 90:] == 0) and torch.all(got[1][0, :40] == 0)
    assert torch.all(got[2][0, :40] == 0)
