"""The arithmetic of the flash attention backward CUDA kernels, emulated in
plain PyTorch on the CPU and held against ``flash_attention_bwd_plain``.

The backward kernels run all five products (S, dP, dV += P^T dO,
dK += dS^T q, dQ += dS K) on TF32 tensor cores in 3xTF32, as the forward
(``tests/test_torch_flash_split.py`` has the pieces and the product). The
emulation follows the kernels tile by tile, with the tiles the source
fixes for the head dim (``tiles``: 64 stationary keys or rows and 32
streamed below 128, 64 and 16 from 128): the dk/dv pass takes each
stationary key tile, lists the streamed query tiles (BS rows R = t G + g
of the kv head's group) that may hold a row seeing one of its keys,
splits that list over blocks of at most ``per`` tiles (``bwd_plan``),
accumulates each split's dK and dV over its tiles in order and sums the
splits in split order; the dq pass does the same per stationary row tile
over its streamed key tiles. From head dim 128 the kernels compute S and
dP over all D columns and each warp accumulates dK, dV (dQ) for its share
of the columns (``kBColsWide`` groups): the emulation takes phase 2's
products a column group at a time. D^-1/2 goes where the kernels put it:
on K's fragments and on the summed dK in the dk/dv pass, on q's fragments
and the summed dQ in the dq pass. It must stay within the kernels'
tolerance, 1e-4 relative and absolute, at T = 512 causal with the heads
cut from llama3.2-1b's 32/8 and gemma2-9b's 16/8 (their plans' cuts
kept), with a window and a softcap (gemma2's 50 at head dim 256), and
with rows and keys that see nothing. One TF32 piece must not: the test
can tell the schemes apart.
"""
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
# the same from head dim 128, and the column groups of dK, dV and dQ there
BT_WIDE = _constant("kBTWide")
BS_WIDE = _constant("kBSWide")
COLS_WIDE = _constant("kBColsWide")
H100_SMS = 132                 # the SM count the plan reads on the H100


def tiles(D):
    """(stationary tile, streamed tile, column groups) of the kernels at
    head dim D, as ``bwd_bt`` / ``bwd_bs`` in ``csrc/flash_attention.cu``."""
    return (BT_WIDE, BS_WIDE, COLS_WIDE) if D >= 128 else (BT, BS, 1)


def bwd_plan(B, T, Hq, Hkv, S, D, sms=H100_SMS):
    """Streamed tiles per block of the dk/dv and the dq pass: about WAVES
    blocks for every SM over a causal call's live tile pairs (half of
    them), no more than MAX_ROWS rows (keys) a block, as ``bwd_pass`` in
    ``csrc/flash_attention.cu``."""
    rows = T * (Hq // Hkv)
    bt, bs, _ = tiles(D)

    def per(n_stat, n_str):
        pairs = max(1, B * Hkv * n_stat * n_str // 2)
        return min(-(-pairs // (WAVES * sms)), MAX_ROWS // bs, n_str)

    return (per(-(-S // bt), -(-rows // bs)),
            per(-(-rows // bt), -(-S // bs)))


def split_ranges(count, per):
    """[i0, i1) of each block of a stationary tile's ``count`` live tiles."""
    splits = -(-count // per) if count > per else 1
    return [(count * r // splits, count * (r + 1) // splits)
            for r in range(splits)]


def emulate_bwd(q, k, v, q_pos, kv_pos, out, lse, dout, *, per_kv, per_q,
                window=None, softcap=None, pieces=2):
    """dq, dk, dv as the kernels compute them."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G, c = Hq // Hkv, D ** -0.5
    rows = T * G
    BT, BS, cols = tiles(D)

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

    def p_ds(b, h, rs, ks, kv_pass):
        # the dk/dv pass scales K's fragments, the dq pass q's
        s = (product(qr[b, h, rs], (k[b, ks, h] * c).T, pieces) if kv_pass
             else product(qr[b, h, rs] * c, k[b, ks, h].T, pieces))
        dp = product(dor[b, h, rs], v[b, ks, h].T, pieces)
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

    def phase2(a, x):     # a @ x, each column group of x on its own
        w = D // cols
        return torch.cat([product(a, x[:, i * w:(i + 1) * w], pieces)
                          for i in range(cols)], dim=-1)

    def summed(parts):    # one split as it is; more in split order, from 0
        if len(parts) == 1:
            return parts[0]
        total = torch.zeros_like(parts[0])
        for part in parts:
            total = total + part
        return total

    for b in range(B):
        for h in range(Hkv):
            for j in range(-(-S // BT)):                      # dk/dv pass
                ks = slice(j * BT, (j + 1) * BT)
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
                        pv = pv + phase2(p.T, dor[b, h, rs])
                        pk = pk + phase2(ds.T, qr[b, h, rs])
                    parts.append((pk, pv))
                dk[b, ks, h] = summed([pk for pk, _ in parts]) * c
                dv[b, ks, h] = summed([pv for _, pv in parts])
            for i in range(-(-rows // BT)):                   # dq pass
                rs = slice(i * BT, (i + 1) * BT)
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
                        pq = pq + phase2(ds, k[b, ks, h])
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
         plan_of=None):
    out, lse = fa_ops.flash_attention_plain(q, k, v, qpos, kpos, window=window,
                                            softcap=softcap, with_lse=True)
    args = (q, k, v, qpos, kpos, out, lse, dout)
    want = fa_ops.flash_attention_bwd_plain(*args, window=window,
                                            softcap=softcap)
    per_kv, per_q = bwd_plan(*(plan_of or (B, T, Hq, Hkv, T)), q.shape[-1])
    got = emulate_bwd(*args, per_kv=per_kv, per_q=per_q, window=window,
                      softcap=softcap, pieces=pieces)
    return _over(got, want)


# T = 512 causal at llama3.2-1b's group of 4 with its heads cut to 8/2 and
# one sequence (the plan of its microbatch, B = 2 at 32/8, kept: 16 tiles
# a block, key tile 0's 64 row tiles split 4 ways), and a window with a
# softcap on the forward case's small shape; at head dim 256, gemma2-9b's
# group of 2 with its heads cut to 4/2 and the plan of its microbatch (B =
# 2 at 16/8: 16 tiles of 16 rows a block, key tile 0's 64 row tiles split
# 4 ways), causal and with a window, both with its softcap of 50; at head
# dim 128, mistral-nemo-12b's group of 4 cut to 8/2 with its plan
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
    """gemma2-9b's cut heads with its softcap and a window: the column
    split and the 16-row tiles change nothing of the scheme's error."""
    _, B, T, Hq, Hkv, D, window, softcap, plan_of = CASES[3]
    q, k, v, qpos, kpos, dout = _inputs(B, T, Hq, Hkv, D, 6)
    args = (B, T, Hq, Hkv, q, k, v, qpos, kpos, dout, window, softcap)
    assert _run(*args, 1, plan_of) > FA_BWD_TOL >= _run(*args, 2, plan_of)


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
    """As above at head dim 128 (64-key tiles, 16-row streamed tiles, the
    column split), every list split one tile a block."""
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
