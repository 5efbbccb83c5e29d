"""The arithmetic of the crossbar_matmul CUDA kernels, emulated in plain
PyTorch on the CPU and held against ``crossbar_matmul_plain``.

Both kernels run on bf16 tensor cores: the codes are exact in bf16, and the
f32 activations are carried as a sum of bf16 pieces, each the bf16
rounding of what the pieces before it left: two pieces leave at most
2^-16 |x|, three (what the kernels use) the f32 rounding. Each piece x
code product is exact in f32; each 128-deep K tile's f32 partial sum is
scaled by its crossbar's scale and added to the running sum. With two or
three pieces that must stay within the kernels' tolerance,
1e-4 * max|y|, at the rwkv6-7b main-path depths (K = 4096 and 14336),
for N(0, 1) activations and for rows spread over six decades (post-norm
activations with outliers). One piece alone (bf16 x) must not: the test
can tell the schemes apart.

The transposed kernel (``crossbar_matmul_t``, dx = g . dequant(W)^T) runs
the same scheme with the roles of K and N swapped: g's three bf16 pieces
against the codes, each 128-wide N tile's partial scaled by
``scales[kt][nt]`` (kt the crossbar row of dx's columns). It is held the
same way against ``crossbar_matmul_t_plain`` at the llama3.2-1b training
depths (K, N of 2048 and 8192).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.core.quant import _unpack4
from repro_torch.kernels.crossbar_matmul import ops as cb_ops

torch.set_num_threads(2)

CB_TOL = 1e-4          # relative to max|y|, as for the kernels on the card
M, N = 16, 256         # narrow N keeps the CPU run short


def split_pieces(x: torch.Tensor, pieces: int):
    """x as a sum of `pieces` bf16 values (in f32), largest first."""
    out, rest = [], x
    for _ in range(pieces):
        p = rest.to(torch.bfloat16).to(torch.float32)
        out.append(p)
        rest = rest - p
    return out


def emulate(x: torch.Tensor, qt: quant.QuantizedTensor, pieces: int):
    """Per 128-deep K tile: sum over pieces of piece @ codes in f32, times
    that crossbar's scale, added to the running sum."""
    codes = (_unpack4(qt.codes) if qt.bits == 4 else qt.codes).to(
        torch.float32)
    kp, np_ = codes.shape
    K, n = qt.orig_shape
    xs = [torch.nn.functional.pad(p, (0, kp - K))
          for p in split_pieces(x, pieces)]
    acc = torch.zeros(x.shape[0], np_ // 128, 128)
    for kt in range(kp // 128):
        rows = slice(128 * kt, 128 * (kt + 1))
        part = sum(p[:, rows] @ codes[rows] for p in xs)
        acc += part.reshape(x.shape[0], -1, 128) * qt.scales[kt][None, :, None]
    return acc.reshape(x.shape[0], np_)[:, :n]


def _case(K, bits, spread, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    if spread:
        x *= (10.0 ** rng.uniform(-3, 3, (M, 1))).astype(np.float32)
    return torch.from_numpy(x), quant.quantize(torch.from_numpy(w), bits)


def emulate_t(g: torch.Tensor, qt: quant.QuantizedTensor, pieces: int):
    """dx = g . dequant(qt)^T as the transposed kernel sums it: per
    (crossbar row kt, N tile nt), the pieces of g times the codes' tile in
    f32, times scales[kt][nt], summed over nt."""
    codes = (_unpack4(qt.codes) if qt.bits == 4 else qt.codes).to(
        torch.float32)
    kp, np_ = codes.shape
    K, n = qt.orig_shape
    c = codes.reshape(kp // 128, 128, np_ // 128, 128)       # (kt, k, nt, n)
    part = sum(torch.einsum("mjn,ikjn->mijk",
                            torch.nn.functional.pad(p, (0, np_ - n)).reshape(
                                g.shape[0], np_ // 128, 128), c)
               for p in split_pieces(g, pieces))              # (m, kt, nt, k)
    dx = (part * qt.scales[None, :, :, None]).sum(dim=2)      # (m, kt, k)
    return dx.reshape(g.shape[0], kp)[:, :K]


@functools.lru_cache(maxsize=None)
def _weight(K, N, bits):
    rng = np.random.default_rng(K + N + bits)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    return quant.quantize(torch.from_numpy(w), bits)


def _case_t(K, N, bits, spread, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((M, N)).astype(np.float32)
    if spread:
        g *= (10.0 ** rng.uniform(-3, 3, (M, 1))).astype(np.float32)
    return torch.from_numpy(g), _weight(K, N, bits)


@pytest.mark.parametrize("pieces", [2, 3])
@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N", [(2048, 8192), (8192, 2048)])
def test_transposed_bf16_pieces_meet_the_kernel_tolerance(K, N, bits, spread,
                                                          pieces):
    g, qt = _case_t(K, N, bits, spread, K + 3 * bits + spread)
    dx_plain = cb_ops.crossbar_matmul_t_plain(g, qt)
    dx = emulate_t(g, qt, pieces=pieces)
    err = float((dx - dx_plain).abs().max())
    assert err <= CB_TOL * float(dx_plain.abs().max()), err


@pytest.mark.parametrize("spread", [False, True])
def test_transposed_one_bf16_piece_breaks_the_kernel_tolerance(spread):
    g, qt = _case_t(2048, 8192, 8, spread, 11 + spread)
    dx_plain = cb_ops.crossbar_matmul_t_plain(g, qt)
    tol = CB_TOL * float(dx_plain.abs().max())
    assert float((emulate_t(g, qt, pieces=1) - dx_plain).abs().max()) > tol
    assert float((emulate_t(g, qt, pieces=3) - dx_plain).abs().max()) <= tol


@pytest.mark.parametrize("pieces", [2, 3])
@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K", [4096, 14336])
def test_bf16_pieces_meet_the_kernel_tolerance(K, bits, spread, pieces):
    x, qt = _case(K, bits, spread, K + bits + spread)
    y_plain = cb_ops.crossbar_matmul_plain(x, qt)
    y = emulate(x, qt, pieces=pieces)
    err = float((y - y_plain).abs().max())
    assert err <= CB_TOL * float(y_plain.abs().max()), err


@pytest.mark.parametrize("spread", [False, True])
def test_one_bf16_piece_breaks_the_kernel_tolerance(spread):
    x, qt = _case(4096, 8, spread, 7 + spread)
    y_plain = cb_ops.crossbar_matmul_plain(x, qt)
    tol = CB_TOL * float(y_plain.abs().max())
    assert float((emulate(x, qt, pieces=1) - y_plain).abs().max()) > tol
    assert float((emulate(x, qt, pieces=2) - y_plain).abs().max()) <= tol


def test_split_is_exact_in_pieces():
    """Two pieces are x to within 2^-16 |x|, three to within one f32
    rounding, and code x piece products are exact in f32 (a bf16 piece
    has 8 significant bits, a code at most 8)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(
        -3, 3, 4096)).astype(np.float32))
    hi, lo = split_pieces(x, 2)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -16
    p = split_pieces(x, 3)
    rest = x.double() - sum(q.double() for q in p)
    assert float((rest.abs() / x.double().abs()).max()) <= 2.0 ** -24
    c = torch.arange(-128, 128, dtype=torch.float32)
    prod = lo[:256] * c
    assert torch.equal(prod.double(), lo[:256].double() * c.double())
