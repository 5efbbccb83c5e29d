"""The wkv recurrence's backward in the port against the JAX package, on
the CPU.

``rwkv6_wkv_bwd_plain`` (the formulas the CUDA backward kernel computes)
and autograd through ``WkvFn`` (which runs that plain version on CPU
tensors, as the kernel on CUDA ones) against ``jax.vjp`` of
``repro.models.rwkv.wkv_scan`` (its chunk-checkpointed scan), and against
torch autograd of the plain recurrence, for all six inputs, from numpy
inputs made from a seed.

Tolerance 1e-5 relative to max |.| of each gradient: the same f32
recurrence on both sides, its sums taken in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jrwkv
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import rwkv

torch.set_num_threads(2)
TOL = 1e-5
NAMES = ("r", "k", "v", "w", "u", "s0")


def _inputs(B, T, H, N, seed, decay="model", clens=None):
    """r, k, v, w, u, s0 and the cotangents dy, ds. Decays exp(-exp(x))
    with x in [-6, -1] as the model makes them ("model"), near 0 ("small":
    x in [1, 3], with exact zeros) or near 1 ("near_one": x in [-12, -8]);
    ragged rows masked as the model masks them (k = 0, w = 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    lo, hi = {"model": (-6.0, -1.0), "small": (1.0, 3.0),
              "near_one": (-12.0, -8.0)}[decay]
    w = np.exp(-np.exp(rng.uniform(lo, hi, (B, T, H, N)))).astype(np.float32)
    if decay == "small":
        w[rng.random((B, T, H, N)) < 0.05] = 0.0
    if clens is not None:
        valid = (np.arange(T)[None] < np.asarray(clens)[:, None])[..., None,
                                                                  None]
        k = np.where(valid, k, 0.0).astype(np.float32)
        w = np.where(valid, w, 1.0).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, N))).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    dy = rng.standard_normal((B, T, H, N)).astype(np.float32)
    ds = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return (r, k, v, w, u, s0), dy, ds


def _jax_grads(args, dy, ds):
    _, vjp = jax.vjp(lambda *a: jrwkv.wkv_scan(*a),
                     *(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(ds)))]


def _close(got, want):
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        assert a.shape == b.shape, name
        atol = TOL * max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


CASES = {
    # T = 1 (JAX's single-step path), T not a multiple of JAX's 64-step
    # chunk, several of its chunks, and of the kernel's 8-step stage
    "T1": (2, 1, 2, 8, "model", None),
    "T37": (1, 37, 2, 16, "model", None),
    "T100": (2, 100, 2, 8, "model", None),
    "T130": (1, 130, 1, 16, "model", None),
    "masked": (3, 21, 2, 8, "model", (21, 9, 0)),
    "small_decay": (2, 40, 2, 8, "small", None),
    "near_one": (2, 70, 2, 8, "near_one", None),
    "N32": (1, 19, 2, 32, "model", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wkv_bwd_plain_and_wkvfn_match_jax_grad(case):
    B, T, H, N, decay, clens = CASES[case]
    args, dy, ds = _inputs(B, T, H, N, seed=T + N, decay=decay, clens=clens)
    want = _jax_grads(args, dy, ds)
    t = [torch.from_numpy(a) for a in args]
    _close(wkv_ops.rwkv6_wkv_bwd_plain(*t, torch.from_numpy(dy),
                                       torch.from_numpy(ds)), want)
    # the wrapper on CPU tensors: the plain version
    _close(wkv_ops.rwkv6_wkv_bwd(*t, torch.from_numpy(dy),
                                 torch.from_numpy(ds)), want)
    # autograd through WkvFn
    live = [x.clone().requires_grad_(True) for x in t]
    y, s = wkv_ops.rwkv6_wkv(*live)
    assert type(y.grad_fn).__name__ == "WkvFnBackward"
    torch.autograd.backward((y, s), (torch.from_numpy(dy),
                                     torch.from_numpy(ds)))
    _close([x.grad for x in live], want)


@pytest.mark.parametrize("case", ["T37", "masked", "small_decay"])
def test_wkv_bwd_plain_matches_autograd_of_the_plain_recurrence(case):
    B, T, H, N, decay, clens = CASES[case]
    args, dy, ds = _inputs(B, T, H, N, seed=3 * T, decay=decay, clens=clens)
    live = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, s = wkv_ops.rwkv6_wkv_plain(*live)
    want = torch.autograd.grad((y, s), live, (torch.from_numpy(dy),
                                              torch.from_numpy(ds)),
                               retain_graph=True)
    got = wkv_ops.rwkv6_wkv_bwd_plain(*(x.detach() for x in live),
                                      torch.from_numpy(dy),
                                      torch.from_numpy(ds))
    _close(got, [g.numpy() for g in want])
    # no ds: the gradient of y alone
    want_y = torch.autograd.grad(y, live, torch.from_numpy(dy))
    got_y = wkv_ops.rwkv6_wkv_bwd_plain(*(x.detach() for x in live),
                                        torch.from_numpy(dy))
    _close(got_y, [g.numpy() for g in want_y])


def test_wkvfn_takes_model_views_and_masking_through_where():
    """As the model calls it: r/k/v/w strided views of one (B, T, 4 H N)
    projection, k and w masked by ``torch.where`` past each row's length,
    u a frozen leaf, s0 zeros, only y used. The gradients reach the
    projection in its shape, masked steps give its k and w parts zero
    gradient, and they equal autograd of the plain recurrence."""
    B, T, H, N = 2, 11, 2, 8
    rng = np.random.default_rng(5)
    proj = torch.from_numpy(rng.standard_normal((B, T, 4 * H * N)).astype(
        np.float32))
    u = torch.from_numpy((0.5 * rng.standard_normal((H, N))).astype(
        np.float32))
    dy = torch.from_numpy(rng.standard_normal((B, T, H, N)).astype(
        np.float32))
    clens = torch.tensor([11, 4])
    grads = []
    for impl in ("auto", "ref"):
        p = proj.clone().requires_grad_(True)
        r, k, v, wx = (p[..., i * H * N:(i + 1) * H * N].reshape(B, T, H, N)
                       for i in range(4))
        w = torch.exp(-torch.exp(wx - 3.0))
        valid = (torch.arange(T)[None] < clens[:, None])[..., None, None]
        k = torch.where(valid, k, torch.zeros(()))
        w = torch.where(valid, w, torch.ones(()))
        assert r.stride() != r.contiguous().stride()
        y, _ = rwkv.wkv_scan(r, k, v, w, u, torch.zeros(B, H, N, N),
                             impl=impl)
        if impl == "auto":
            assert type(y.grad_fn).__name__ == "WkvFnBackward"
        (y * dy).sum().backward()
        grads.append(p.grad)
    got, want = grads
    assert got.shape == proj.shape
    masked = got[1, 4:].reshape(T - 4, 4, H * N)
    assert torch.all(masked[:, 1] == 0) and torch.all(masked[:, 3] == 0)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=TOL * float(want.abs().max()))


def test_wkvfn_returns_only_the_gradients_asked_for():
    """Only r and v need a gradient (layer 0 of the model: k and w read
    the frozen embedding): the others get none."""
    args, dy, _ = _inputs(1, 9, 2, 8, seed=1)
    t = [torch.from_numpy(a) for a in args]
    t[0].requires_grad_(True)
    t[2].requires_grad_(True)
    y, _ = wkv_ops.rwkv6_wkv(*t)
    (y * torch.from_numpy(dy)).sum().backward()
    assert t[0].grad is not None and t[2].grad is not None
    assert all(t[i].grad is None for i in (1, 3, 4, 5))
    with torch.no_grad():
        y2, _ = wkv_ops.rwkv6_wkv(*t)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


def test_wkv_bwd_refuses_what_it_does_not_take():
    args, dy, ds = _inputs(1, 4, 2, 8, seed=0)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="dy"):
        wkv_ops.rwkv6_wkv_bwd(*t, torch.from_numpy(dy)[:, :2])
    with pytest.raises(ValueError, match="ds"):
        wkv_ops.rwkv6_wkv_bwd(*t, torch.from_numpy(dy),
                              torch.from_numpy(ds)[..., :4])
    # no silent fallback: a tensor that is neither on the CPU nor on CUDA
    with pytest.raises(ValueError):
        wkv_ops.rwkv6_wkv_bwd(*(a.to("meta") for a in t),
                              torch.from_numpy(dy).to("meta"))


def test_bwd_workspace_holds_the_checkpoints():
    """The chunked kernel: per (b, h) one state per started 16-step
    sub-chunk (67.1 MB at the train microbatch). The recurrence: one per
    started 64-step chunk and eight more for the chunk being walked (16.8
    + 16.8 MB)."""
    assert (wkv_ops._bwd_need(2, 512, 64, 64, chunked=True)
            == 2 * 64 * 32 * 64 * 64)
    assert wkv_ops._bwd_need(1, 17, 1, 64, chunked=True) == 2 * 64 * 64
    assert wkv_ops._bwd_need(1, 0, 1, 64, chunked=True) == 0
    assert (wkv_ops._bwd_need(2, 512, 64, 64, chunked=False)
            == 2 * 64 * (8 + 8) * 64 * 64)
    assert wkv_ops._bwd_need(1, 65, 1, 8, chunked=False) == (2 + 8) * 64
    assert wkv_ops._bwd_need(1, 1, 1, 8, chunked=False) == (1 + 8) * 64
