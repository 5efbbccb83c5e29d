"""The arithmetic of the chunked rwkv6 wkv CUDA kernel, emulated in plain
PyTorch on the CPU and held against ``rwkv6_wkv_plain`` and JAX
``wkv_scan``.

The kernel walks the time axis in sub-chunks of L = 16 steps and carries
the N x N state S from one sub-chunk to the next. Inside a sub-chunk
starting at state S, with every decay a forward product of w (each <= 1,
so nothing overflows, no log is taken, and w = 0 and w = 1 stay exact):

    y_t  = (r_t * P_t) . S  +  sum_{s<t} A[t, s] v_s  +  (r_t . (u * k_t)) v_t
    S'   = diag(P_L) S  +  sum_s (k_s * Q_s)^T v_s

with P_t = prod_{tau<t} w_tau (P_L: the whole sub-chunk), Q_s =
prod_{s<tau<L} w_tau and A[t, s] = sum_i r_t,i k_s,i prod_{s<tau<t}
w_tau,i, a running product that is never divided. The three products
((r * P) S, A V and (k * Q)^T V) run on TF32 tensor cores in 3xTF32: every
f32 operand x becomes big = x rounded to TF32 and small = x - big rounded
to TF32, and each product is small.big + big.small + big.big in f32. A and
the decay products are f32 SIMT. Steps past T are w = 1, k = r = v = 0.

Tolerance: 1e-5 of (1 + the plain output's largest magnitude), as
``chip_smoke.py`` holds the kernel (WKV_TOL); at the Pallas sweep's
inputs also elementwise rtol = atol = 1e-5, as ``tests/test_kernels.py``
holds the Pallas kernel. One TF32 piece must fail: the test can tell the
schemes apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jrwkv
from repro_torch import kernels
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

torch.set_num_threads(2)

WKV_TOL = 1e-5
SUB = 16                   # steps of a sub-chunk, as in csrc/rwkv6_wkv.cu


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Nearest TF32, ties away from zero (two integer ops in the kernel)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def pieces_of(x: torch.Tensor, pieces: int):
    big = tf32_round(x)
    return [big] if pieces == 1 else [big, tf32_round(x - big)]


def product(a: torch.Tensor, b: torch.Tensor, pieces: int) -> torch.Tensor:
    """a @ b (batched) as the tensor cores compute it: 3xTF32 or one piece."""
    ap, bp = pieces_of(a, pieces), pieces_of(b, pieces)
    if pieces == 1:
        return ap[0] @ bp[0]
    return ap[1] @ bp[0] + ap[0] @ bp[1] + ap[0] @ bp[0]


def emulate(r, k, v, w, u, s0, *, pieces=2):
    """The chunked kernel's arithmetic for r/k/v/w (B, T, H, N), u (H, N),
    s0 (B, H, N, N). Returns y (B, T, H, N), s_final (B, H, N, N)."""
    B, T, H, N = r.shape
    n_sub = -(-T // SUB)
    pad = n_sub * SUB - T

    def steps(x, fill):     # (B, H, n_sub, SUB, N), padded steps = fill
        x = x.permute(0, 2, 1, 3)
        x = torch.cat([x, torch.full((B, H, pad, N), fill)], dim=2)
        return x.reshape(B, H, n_sub, SUB, N)

    rs, ks, vs, ws = (steps(x, f) for x, f in ((r, 0.0), (k, 0.0), (v, 0.0),
                                               (w, 1.0)))
    s = s0.clone()
    ys = []
    for c in range(n_sub):
        rc, kc, vc, wc = rs[:, :, c], ks[:, :, c], vs[:, :, c], ws[:, :, c]
        # forward products P_t (before step t) and the backward ones Q_s
        p = torch.ones(B, H, N)
        r_dec = torch.empty_like(rc)
        for t in range(SUB):
            r_dec[:, :, t] = rc[:, :, t] * p
            p = p * wc[:, :, t]
        q = torch.ones(B, H, N)
        k_dec = torch.empty_like(kc)
        for t in reversed(range(SUB)):
            k_dec[:, :, t] = kc[:, :, t] * q
            q = q * wc[:, :, t]
        # A: lower triangle by running products, the u bonus on the diagonal
        a = torch.zeros(B, H, SUB, SUB)
        for s_ in range(SUB):
            a[:, :, s_, s_] = (rc[:, :, s_] * u * kc[:, :, s_]).sum(-1)
            kd = kc[:, :, s_]
            for t in range(s_ + 1, SUB):
                a[:, :, t, s_] = (rc[:, :, t] * kd).sum(-1)
                kd = kd * wc[:, :, t]
        ys.append(product(r_dec, s, pieces) + product(a, vc, pieces))
        s = p[..., :, None] * s + product(k_dec.transpose(-1, -2), vc, pieces)
    y = torch.cat(ys, dim=2)[:, :, :T]
    return y.permute(0, 2, 1, 3).contiguous(), s


DECAYS = ["one", "near_one", "pallas", "model", "zeros"]


def _inputs(B, T, H, N, decay, seed, clens=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    shape = (B, T, H, N)
    if decay == "one":
        w = np.ones(shape, np.float32)
    elif decay == "near_one":
        w = np.full(shape, 1.0 - 1e-4, np.float32)
    elif decay == "pallas":       # tests/test_kernels.py: [0.45, 0.95]
        w = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape))) * 0.5
             + 0.45).astype(np.float32)
    else:                         # as the model makes it, x in [-6, 3]
        x = rng.uniform(-6.0, 3.0, shape).astype(np.float32)
        w = np.exp(-np.exp(x)).astype(np.float32)
        if decay == "zeros":      # ~5% exact zeros (x >~ 4.5 underflows)
            w[rng.random(shape) < 0.05] = 0.0
    u = (rng.standard_normal((H, N)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32)
    if clens is not None:         # masked as the model masks ragged rows
        valid = np.arange(T)[None] < np.asarray(clens)[:, None]
        k = np.where(valid[..., None, None], k, 0.0).astype(np.float32)
        w = np.where(valid[..., None, None], w, 1.0).astype(np.float32)
    return r, k, v, w, u, s0


def _err(out, ref):
    return max(float((out[0] - ref[0]).abs().max()),
               float((out[1] - ref[1]).abs().max()))


def _tol(ref):
    return WKV_TOL * (1.0 + max(float(ref[0].abs().max()),
                                float(ref[1].abs().max())))


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("T", [1, 15, 16, 17, 63, 64, 65, 128, 200])
def test_chunked_wkv_meets_the_kernel_tolerance(T, decay):
    args = [torch.from_numpy(a) for a in _inputs(2, T, 2, 64, decay, T)]
    plain = wkv_ops.rwkv6_wkv_plain(*args)
    out = emulate(*args)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert _err(out, plain) <= _tol(plain)


@pytest.mark.parametrize("decay", ["pallas", "zeros"])
def test_chunked_wkv_matches_jax_scan(decay):
    """Against the JAX package's own recurrence, at a T that ends inside a
    sub-chunk, and elementwise at the Pallas sweep's inputs."""
    arrays = _inputs(1, 75, 3, 64, decay, 7)
    y_j, s_j = jrwkv.wkv_scan(*map(jnp.asarray, arrays))
    ref = (torch.from_numpy(np.array(y_j)), torch.from_numpy(np.array(s_j)))
    out = emulate(*map(torch.from_numpy, arrays))
    assert _err(out, ref) <= _tol(ref)
    if decay == "pallas":
        for o, x in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), x.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_ragged_rows_and_an_empty_row():
    """Rows of 200, 37, 16, 1 and 0 valid steps, padded as the model pads
    them (k = 0, w = 1): the empty row's state comes back bit for bit."""
    clens = (200, 37, 16, 1, 0)
    args = [torch.from_numpy(a)
            for a in _inputs(5, 200, 2, 64, "model", 3, clens=clens)]
    plain = wkv_ops.rwkv6_wkv_plain(*args)
    out = emulate(*args)
    assert _err(out, plain) <= _tol(plain)
    assert torch.equal(out[1][4], args[5][4])


def test_one_tf32_piece_breaks_the_kernel_tolerance():
    args = [torch.from_numpy(a) for a in _inputs(2, 128, 2, 64, "model", 1)]
    plain = wkv_ops.rwkv6_wkv_plain(*args)
    err1 = _err(emulate(*args, pieces=1), plain)
    err3 = _err(emulate(*args), plain)
    assert err1 > _tol(plain) >= err3


def test_tiny_decays_never_give_nan_or_inf():
    """Decays that underflow a product of 16 steps to 0 (w ~ 1e-30), mixed
    with exact zeros and ones: the products only shrink, never divide."""
    r, k, v, w, u, s0 = _inputs(2, 64, 2, 64, "model", 11)
    rng = np.random.default_rng(5)
    w = np.where(rng.random(w.shape) < 0.5, np.float32(1e-30), w)
    w[:, ::7] = 0.0
    w[:, 3::11] = 1.0
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    plain = wkv_ops.rwkv6_wkv_plain(*args)
    out = emulate(*args)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert _err(out, plain) <= _tol(plain)


def test_pieces_carry_f32():
    """big + small is x to within 2^-22 |x|; big alone to within 2^-11."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(
        -3, 3, 4096)).astype(np.float32))
    big, small = pieces_of(x, 2)
    rel = lambda r: float((r.abs() / x.double().abs()).max())  # noqa: E731
    assert rel(x.double() - big.double()) <= 2.0 ** -11
    assert rel(x.double() - big.double() - small.double()) <= 2.0 ** -22
    for p in (big, small):
        assert int((p.view(torch.int32) & 0x1FFF).abs().max()) == 0


@pytest.mark.parametrize("kernel", ["auto", "recurrent", "chunk"])
def test_cpu_tensors_take_the_plain_version_for_any_kernel(kernel):
    args = [torch.from_numpy(a) for a in _inputs(1, 20, 2, 64, "model", 2)]
    kernels.reset_launches()
    out = wkv_ops.rwkv6_wkv(*args, kernel=kernel)
    plain = wkv_ops.rwkv6_wkv_plain(*args)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])
    with pytest.raises(ValueError, match="kernel"):
        wkv_ops.rwkv6_wkv(*args, kernel="fast")
