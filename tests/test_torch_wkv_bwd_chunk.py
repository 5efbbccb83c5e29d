"""The arithmetic of the chunked rwkv6 wkv backward CUDA kernel
(``wkv_bwd_chunk_kernel`` in ``csrc/rwkv6_wkv.cu``), emulated in plain
PyTorch on the CPU and held against ``jax.vjp`` of the JAX package's
``wkv_scan`` and against ``rwkv6_wkv_bwd_plain``.

The kernel walks the time axis in sub-chunks of L = 16 steps, as the
chunked forward does. A forward sweep keeps the state S at the start of
every sub-chunk; then, from the last sub-chunk, with dSe the gradient of
the state after the sub-chunk's last step and every decay a forward
product of w (never a quotient or a log, so w = 0 and w = 1 stay exact):

    P_t = prod_{tau<t} w_tau,  Q_s = prod_{s<tau<L} w_tau,
    D(s, t) = prod_{s<tau<t} w_tau,
    A[t, s] = sum_i r_t,i k_s,i D_i(s, t) (s < t), a_t = r_t . (u * k_t),
    H = dY S^T, G = V dSe^T, dA = dY V^T (s < t), vd_t = v_t . dy_t,
    c_i = sum_j S_ij dSe_ij,

    dr_t = P_t H_t + sum_{s<t} dA[t, s] k_s D(s, t) + u k_t vd_t
    dk_s = Q_s G_s + sum_{t>s} dA[t, s] r_t D(s, t) + u r_s vd_s
    dv_s = (k_s Q_s)^T dSe + sum_{t>s} A[t, s] dy_t + a_s dy_s
    dw_tau = c P_tau Q_tau + P_tau x_tau + Q_tau y_tau + z_tau,
      x_tau = sum_{t>tau} D(tau, t) r_t H_t   (a backward scan),
      y_tau = sum_{s<tau} D(s, tau) k_s G_s   (a forward scan),
      z_tau = sum_{s<tau<t} D(s, tau) D(tau, t) k_s r_t dA[t, s]
            = sum_s alpha_tau[s] beta_tau[s], alpha_tau[s] = D(s, tau) k_s
              (forward in tau), beta_tau[s] = sum_{t>tau} D(tau, t) r_t
              dA[t, s] (backward in tau); beta_s[s] is dk_s's middle term
    du += sum_t r_t k_t vd_t
    dS_in = diag(P_L) dSe + (R * P)^T dY   (the next sub-chunk's dSe)

Each decay in dw excludes w_tau itself: nothing is divided. The kernel
splits the key rows i of S and dS over G = 4 groups of warps of one block
per (b, h): rows evolve independently, so every term but dv is local to a
group's rows; dv's is a partial over them, and the G partials are summed
in group order.
The products (H, G, dA, (K Q)^T dSe, A^T dY, (R P)^T dY and the sweep's
(K Q)^T V) run on TF32 tensor cores in 3xTF32 (``product`` of
``tests/test_torch_wkv_chunk.py``), the decays, A, the scans and the
rest in f32. Steps past T are w = 1 and r = k = v = dy = 0.

Tolerance: 1e-4 of each gradient's max |.|, as ``chip_smoke.py`` holds the
kernel on the card (FA_BWD_TOL). One TF32 piece must fail it: the test
can tell the schemes apart.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from test_torch_wkv_bwd import NAMES, _inputs, _jax_grads
from test_torch_wkv_chunk import product

torch.set_num_threads(2)

TOL = 1e-4
SUB = 16        # steps of a sub-chunk, as in csrc/rwkv6_wkv.cu
GROUPS = 4      # blocks of a cluster, each a quarter of the key rows


def _pad(x, n_sub, fill):
    """(B, T, H, N) -> (B, H, n_sub, SUB, N), steps past T = fill."""
    B, T, H, N = x.shape
    x = x.permute(0, 2, 1, 3)
    x = torch.cat([x, torch.full((B, H, n_sub * SUB - T, N), fill)], dim=2)
    return x.reshape(B, H, n_sub, SUB, N)


def _tr(x):
    return x.transpose(-1, -2)


def emulate_bwd(r, k, v, w, u, s0, dy, ds=None, *, pieces=2,
                groups=GROUPS):
    """The kernel's arithmetic for r/k/v/w/dy (B, T, H, N), u (H, N), s0 and
    ds (B, H, N, N; ds None for zero). Returns (dr, dk, dv, dw, du, ds0).
    ``groups`` row groups give dv's partials; ``pieces`` 1 runs the
    products in one TF32 piece."""
    B, T, H, N = r.shape
    n_sub = -(-T // SUB)
    rs, ks, vs, dys = (_pad(x, n_sub, 0.0) for x in (r, k, v, dy))
    ws = _pad(w, n_sub, 1.0)
    rows = [slice(g * N // groups, (g + 1) * N // groups)
            for g in range(groups)]
    one = torch.ones(B, H, N)

    def decays(wc):
        """P_t (t = 0 .. L) and Q_s, each (B, H, L (+1), N)."""
        p = [one]
        for t in range(SUB):
            p.append(p[-1] * wc[:, :, t])
        q = [one]
        for t in reversed(range(1, SUB)):
            q.append(q[-1] * wc[:, :, t])
        return torch.stack(p, 2), torch.stack(q[::-1], 2)

    # 1. the sweep: the state at the start of every sub-chunk
    s, starts = s0.clone(), []
    for c in range(n_sub):
        starts.append(s)
        p, q = decays(ws[:, :, c])
        s = (p[:, :, SUB, :, None] * s
             + product(_tr(ks[:, :, c] * q), vs[:, :, c], pieces))
    # 2. the sub-chunks from the last
    d_s = torch.zeros(B, H, N, N) if ds is None else ds.clone()
    out = {n: torch.zeros(B, H, n_sub, SUB, N) for n in ("r", "k", "v", "w")}
    du_rows = torch.zeros(B, H, N)
    tril = torch.tril(torch.ones(SUB, SUB), -1)
    for c in reversed(range(n_sub)):
        S = starts[c]
        rc, kc, vc, wc, dyc = (x[:, :, c] for x in (rs, ks, vs, ws, dys))
        p, q = decays(wc)
        h_ = product(dyc, _tr(S), pieces)                   # (B, H, t, i)
        g_ = product(vc, _tr(d_s), pieces)                  # (B, H, s, i)
        da_full = product(dyc, _tr(vc), pieces)             # (B, H, t, s)
        vd = torch.diagonal(da_full, dim1=-2, dim2=-1)      # (B, H, t)
        da = da_full * tril
        cc = (S * d_s).sum(-1)                              # (B, H, i)
        # dv: a partial over each group's key rows, summed in group order
        dv = None
        for sl in rows:
            ri, ki, wi = rc[..., sl], kc[..., sl], wc[..., sl]
            a_part = torch.zeros(B, H, SUB, SUB)            # A[t, s]
            for s_ in range(SUB):
                a_part[:, :, s_, s_] = (ri[:, :, s_] * u[:, sl]
                                        * ki[:, :, s_]).sum(-1)
                kd = ki[:, :, s_]
                for t in range(s_ + 1, SUB):
                    a_part[:, :, t, s_] = (ri[:, :, t] * kd).sum(-1)
                    kd = kd * wi[:, :, t]
            part = (product(ki * q[..., sl], d_s[:, :, sl], pieces)
                    + product(_tr(a_part), dyc, pieces))
            dv = part if dv is None else dv + part
        out["v"][:, :, c] = dv
        # the per-row scans, as one thread per (row i, step s) runs them
        beta = torch.zeros(B, H, SUB, SUB, N)               # [tau, s, i]
        b = torch.zeros(B, H, SUB, N)
        x_sc = torch.zeros(B, H, SUB, N)
        xr = torch.zeros(B, H, N)
        for tau in reversed(range(SUB)):
            beta[:, :, tau] = b
            x_sc[:, :, tau] = xr
            b = (wc[:, :, tau, None] * b
                 + rc[:, :, tau, None] * da[:, :, tau, :, None])
            xr = wc[:, :, tau] * xr + rc[:, :, tau] * h_[:, :, tau]
        alpha = torch.zeros(B, H, SUB, N)
        z = torch.zeros(B, H, SUB, N)
        drc = torch.zeros(B, H, SUB, N)
        y_sc = torch.zeros(B, H, SUB, N)
        yf = torch.zeros(B, H, N)
        for tau in range(SUB):
            z[:, :, tau] = (alpha * beta[:, :, tau]).sum(2)
            drc[:, :, tau] = (alpha * da[:, :, tau, :, None]).sum(2)
            y_sc[:, :, tau] = yf
            alpha = alpha * wc[:, :, tau, None]
            alpha[:, :, tau] = kc[:, :, tau]
            yf = wc[:, :, tau] * yf + kc[:, :, tau] * g_[:, :, tau]
        pp, vdn, uu = p[:, :, :SUB], vd[..., None], u[:, None]
        beta_diag = torch.diagonal(beta, dim1=2, dim2=3).transpose(-1, -2)
        out["r"][:, :, c] = pp * h_ + drc + uu * kc * vdn
        out["k"][:, :, c] = q * g_ + beta_diag + uu * rc * vdn
        out["w"][:, :, c] = (cc[:, :, None] * pp * q + pp * x_sc + q * y_sc
                             + z)
        du_rows += (rc * kc * vdn).sum(2)
        d_s = (p[:, :, SUB, :, None] * d_s
               + product(_tr(rc * pp), dyc, pieces))
    grads = [out[n].reshape(B, H, n_sub * SUB, N)[:, :, :T].permute(0, 2, 1, 3)
             for n in ("r", "k", "v", "w")]
    return (*grads, du_rows.sum(0), d_s)


def _over(got, want):
    """The largest error of a gradient over TOL times its max |.|, and
    whether each is finite."""
    worst = 0.0
    for name, a, b in zip(NAMES, got, want):
        b = torch.as_tensor(np.array(b))
        assert a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        scale = max(float(b.abs().max()), 1e-30)
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def _case(B, T, H, N, decay, seed, clens=None, with_ds=True):
    args, dy, ds = _inputs(B, T, H, N, seed=seed, decay=decay, clens=clens)
    t = [torch.from_numpy(a) for a in args]
    ds_t = torch.from_numpy(ds) if with_ds else None
    return t, torch.from_numpy(dy), ds_t, (args, dy, ds)


@pytest.mark.parametrize("decay", ["model", "small", "near_one"])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 64, 65, 130])
def test_chunked_bwd_meets_the_kernel_tolerance(T, decay):
    """Against rwkv6_wkv_bwd_plain at every T (one step, ragged and whole
    sub-chunks, several 64-step spans), small decays with 5% exact zeros
    and decays near one."""
    t, dy, ds, _ = _case(1, T, 2, 16, decay, seed=T)
    want = wkv_ops.rwkv6_wkv_bwd_plain(*t, dy, ds)
    assert _over(emulate_bwd(*t, dy, ds), want) <= TOL


@pytest.mark.parametrize("decay", ["model", "small"])
@pytest.mark.parametrize("T", [17, 65])
def test_chunked_bwd_matches_jax_vjp(T, decay):
    """Against jax.vjp of repro.models.rwkv.wkv_scan (its 64-step
    checkpointed scan), exact zeros in w included."""
    t, dy, ds, (args, dy_np, ds_np) = _case(2, T, 2, 16, decay, seed=2 * T)
    assert _over(emulate_bwd(*t, dy, ds),
                 _jax_grads(args, dy_np, ds_np)) <= TOL


@pytest.mark.parametrize("with_ds", [True, False])
def test_ragged_rows_with_and_without_ds(with_ds):
    """Rows of 130, 37, 16 and 0 valid steps, masked as the model masks
    them (k = 0, w = 1); the gradient of the final state given or None."""
    t, dy, ds, _ = _case(4, 130, 2, 16, "model", seed=9,
                         clens=(130, 37, 16, 0), with_ds=with_ds)
    want = wkv_ops.rwkv6_wkv_bwd_plain(*t, dy, ds)
    assert _over(emulate_bwd(*t, dy, ds), want) <= TOL


def test_dv_partials_sum_to_the_whole():
    """The G = 4 row groups' partials of dv, summed in group order,
    against one group holding every row (G = 1)."""
    t, dy, ds, _ = _case(1, 40, 2, 16, "model", seed=4)
    split = emulate_bwd(*t, dy, ds)
    whole = emulate_bwd(*t, dy, ds, groups=1)
    assert _over(split, whole) <= TOL
    for a, b in zip(split, whole):
        if a is not split[2]:
            assert torch.equal(a, b)


def test_one_tf32_piece_breaks_the_kernel_tolerance():
    t, dy, ds, _ = _case(1, 130, 2, 16, "model", seed=1)
    want = wkv_ops.rwkv6_wkv_bwd_plain(*t, dy, ds)
    assert _over(emulate_bwd(*t, dy, ds, pieces=1), want) > TOL
    assert _over(emulate_bwd(*t, dy, ds), want) <= TOL


@pytest.mark.parametrize("kernel", wkv_ops.KERNELS)
def test_cpu_tensors_take_the_plain_version_for_any_kernel(kernel):
    """On CPU tensors every ``kernel`` runs rwkv6_wkv_bwd_plain and counts
    no launch; an unknown one is refused."""
    t, dy, ds, _ = _case(1, 20, 2, 16, "model", seed=2)
    kernels.reset_launches()
    got = wkv_ops.rwkv6_wkv_bwd(*t, dy, ds, kernel=kernel)
    want = wkv_ops.rwkv6_wkv_bwd_plain(*t, dy, ds)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="kernel"):
        wkv_ops.rwkv6_wkv_bwd(*t, dy, ds, kernel="fast")
