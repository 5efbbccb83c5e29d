"""Port parity for the Mamba block (jamba-1.5-large-398b's 7-of-8 layers):
the selective scan's plain version, the causal conv, the block with its
LoRA targets and its FLOP tally, against the JAX package's
``repro.models.ssm`` on the same inputs and weights (carried across by
``repro_torch.bridge``), on the CPU. Every JAX call is jitted, once per
shape.

Tolerances: the scan 1e-4 (rtol and atol), as ``tests/test_ssm_rwkv.py``
holds the JAX chunked scan to its per-step oracle: the port's plain
version is that per-step recurrence, JAX's an associative scan over
chunks (other products, other order). The conv, the block and its LoRA
deltas 1e-5 (rtol and atol): the same f32 arithmetic, the scan and the
projections summed in other orders. The FLOP tally is exact at T <=
``mamba.chunk``, where the JAX package's (which records its scan body
once) counts every chunk.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.core import hetero as jhetero
from repro.models import ssm as jssm
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import hetero
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.models import ssm

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(11)
SCAN_TOL = 1e-4
TOL = 1e-5
ARCH = "jamba-1.5-large-398b"


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol,
                               atol=tol)


def _cfgs():
    """Reduced jamba (d 64, d_in 128, d_state 4, dt_rank 8, chunk 16) with
    LoRA on the attention and both Mamba targets, on each side."""
    targets = ("wq", "wv", "mamba_in", "mamba_out")
    jcfg = jax_reduce_config(jax_get_config(ARCH))
    cfg = reduce_config(get_config(ARCH))
    return (dataclasses.replace(jcfg, lora=dataclasses.replace(
                jcfg.lora, targets=targets)),
            dataclasses.replace(cfg, lora=dataclasses.replace(
                cfg.lora, targets=targets)))


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _cfgs()
    jp = jax.jit(lambda k: jssm.init_mamba(jcfg, k, jnp.float32))(KEY)
    mc = cfg.mamba
    d, d_in, r = cfg.d_model, mc.expand * cfg.d_model, cfg.lora.rank
    rng = np.random.default_rng(4)

    def ab(din, dout):
        # two adapters, B != 0
        return {"a": (0.2 * rng.standard_normal((2, din, r))).astype(
                    np.float32),
                "b": (0.2 * rng.standard_normal((2, r, dout))).astype(
                    np.float32)}

    lora = {"mamba_in": ab(d, 2 * d_in), "mamba_out": ab(d_in, d)}
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=_to_torch(jp), lora=lora,
                tlora=_to_torch(lora))


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------


def _scan_inputs(B, T, D, N, seed, h0_scale=0.0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, D)))).astype(np.float32)
    Bc = rng.standard_normal((B, T, N)).astype(np.float32)
    Cc = rng.standard_normal((B, T, N)).astype(np.float32)
    xi = rng.standard_normal((B, T, D)).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal((D, N)))).astype(np.float32)
    h0 = (h0_scale * rng.standard_normal((B, D, N))).astype(np.float32)
    return dt, Bc, Cc, xi, A, h0


@functools.lru_cache(maxsize=None)
def _jax_scan(chunk):
    return jax.jit(lambda *a: jssm._selective_scan(*a, chunk))


@pytest.mark.parametrize("h0_scale", [0.0, 1.0], ids=["zero", "carried"])
@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_selective_scan_plain_matches_jax_at_any_chunk(chunk, h0_scale):
    """B 2, T 50, D 8, N 4, from a zero and from a carried state: the
    plain recurrence against JAX's chunked scan (chunks of 4 and 16 leave
    a padded tail), and the wrapper on CPU tensors is the plain version."""
    args = _scan_inputs(2, 50, 8, 4, seed=chunk, h0_scale=h0_scale)
    yj, hj = _jax_scan(chunk)(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    y, h = scan_ops.selective_scan_plain(*targs)
    _close(y, yj, SCAN_TOL)
    _close(h, hj, SCAN_TOL)
    before = dict(kernels.LAUNCHES)
    yw, hw = scan_ops.selective_scan(*targs)
    assert kernels.LAUNCHES == before          # the plain version ran
    assert torch.equal(yw, y) and torch.equal(hw, h)


def test_selective_scan_zero_dt_is_an_identity_step():
    """A step with dt = 0 (how the model masks a ragged tail) leaves the
    state as it was, bit for bit; T = 0 returns the incoming state."""
    dt, Bc, Cc, xi, A, h0 = (torch.from_numpy(a) for a in _scan_inputs(
        2, 9, 8, 4, seed=5, h0_scale=1.0))
    dt[1, 4:] = 0.0
    _, h_full = scan_ops.selective_scan_plain(dt, Bc, Cc, xi, A, h0)
    _, h_cut = scan_ops.selective_scan_plain(dt[:, :4], Bc[:, :4], Cc[:, :4],
                                             xi[:, :4], A, h0)
    assert torch.equal(h_full[1], h_cut[1])
    y0, h_0 = scan_ops.selective_scan_plain(dt[:, :0], Bc[:, :0], Cc[:, :0],
                                            xi[:, :0], A, h0)
    assert y0.shape == (2, 0, 8) and torch.equal(h_0, h0)


@pytest.mark.parametrize("kernel", scan_ops.KERNELS)
def test_selective_scan_kernel_choice_on_cpu_is_the_plain_version(kernel):
    """On CPU tensors every choice of ``kernel`` runs the plain
    version, at T on both sides of ``CHUNK_MIN_T``; an unknown name
    raises."""
    for T in (scan_ops.CHUNK_MIN_T - 1, scan_ops.CHUNK_MIN_T):
        args = [torch.from_numpy(a) for a in _scan_inputs(2, T, 8, 4,
                                                          seed=T)]
        before = dict(kernels.LAUNCHES)
        y, h = scan_ops.selective_scan(*args, kernel=kernel)
        assert kernels.LAUNCHES == before
        yp, hp = scan_ops.selective_scan_plain(*args)
        assert torch.equal(y, yp) and torch.equal(h, hp)
        with pytest.raises(ValueError, match="kernel"):
            scan_ops.selective_scan(*args, kernel="split")


def test_selective_scan_refuses_bad_shapes_and_differentiates_on_cpu():
    args = [torch.from_numpy(a) for a in _scan_inputs(1, 6, 8, 4, seed=6)]
    with pytest.raises(ValueError, match="Bc"):
        scan_ops.selective_scan(args[0], args[1][:, :5], *args[2:])
    # on the CPU autograd runs through the plain recurrence
    x = args[3].clone().requires_grad_(True)
    y, _ = scan_ops.selective_scan(*args[:3], x, *args[4:])
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


# ---------------------------------------------------------------------------
# the causal conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lens", [None, (0, 6, 3, 1)], ids=["whole",
                                                           "ragged"])
def test_causal_conv_matches_jax(lens):
    """Depthwise conv over time from a carried tail; with ``valid_len`` the
    emitted tail is each row's last K-1 valid inputs, and a row of length
    0 keeps its incoming state bit for bit."""
    rng = np.random.default_rng(8)
    B, T, C, K = 4, 6, 16, 4
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    st = rng.standard_normal((B, K - 1, C)).astype(np.float32)
    vl = None if lens is None else np.asarray(lens, np.int32)
    oj, sj = jax.jit(jssm._causal_conv)(
        *map(jnp.asarray, (x, w, b, st)),
        None if vl is None else jnp.asarray(vl))
    ot, s_t = ssm._causal_conv(
        *map(torch.from_numpy, (x, w, b, st)),
        None if vl is None else torch.from_numpy(vl))
    _close(ot, oj, TOL)
    _close(s_t, sj, TOL)
    if lens is not None:
        assert torch.equal(s_t[0], torch.from_numpy(st[0]))       # len 0
        assert torch.equal(s_t[1], torch.from_numpy(x[1, T - K + 1:]))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_block(jcfg, with_cache, ragged, with_lora):
    def run(p, x, cache, clens, lora, idx):
        return jssm.apply_mamba_block(
            jcfg, p, x, cache=cache if with_cache else None,
            lora=lora if with_lora else None,
            adapter_idx=idx if with_lora else None,
            chunk_lens=clens if ragged else None)
    return jax.jit(run)


def _block(setup, x, cache=None, clens=None, lora=False):
    """The block on both sides: ((y, cache) JAX, (y, cache) port)."""
    idx = np.arange(x.shape[0], dtype=np.int32) % 2
    none = np.zeros((), np.float32)
    jout = _jax_block(setup["jcfg"], cache is not None, clens is not None,
                      lora)(
        setup["jp"], jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache) if cache is not None else none,
        jnp.asarray(clens) if clens is not None else none,
        jax.tree.map(jnp.asarray, setup["lora"]), jnp.asarray(idx))
    tout = ssm.apply_mamba_block(
        setup["cfg"], setup["tp"], torch.from_numpy(x),
        cache=_to_torch(cache) if cache is not None else None,
        lora=setup["tlora"] if lora else None,
        adapter_idx=torch.from_numpy(idx).long() if lora else None,
        chunk_lens=torch.from_numpy(clens) if clens is not None else None)
    return jout, tout


def _state(cfg, B, rng, scale=1.0):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    return {"conv": (scale * rng.standard_normal(
                (B, mc.d_conv - 1, d_in))).astype(np.float32),
            "ssm": (scale * rng.standard_normal(
                (B, d_in, mc.d_state))).astype(np.float32)}


def test_mamba_block_full_sequence_matches_jax(setup):
    x = np.random.default_rng(1).standard_normal(
        (2, 12, setup["cfg"].d_model)).astype(np.float32)
    (yj, _), (yt, ct) = _block(setup, x)
    assert ct is None
    _close(yt, yj, TOL)


def test_mamba_block_prefill_then_decode_matches_jax_and_full(setup):
    """Prefill 8 tokens from a zero state, then 4 decode steps carrying
    the conv tail and the SSM state: each step against JAX, and the
    outputs against the whole 12-token sequence."""
    cfg = setup["cfg"]
    x = np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    cache = jax.tree.map(np.zeros_like, _state(cfg, 2,
                                               np.random.default_rng(0)))
    (yj, cj), (yt, ct) = _block(setup, x[:, :8], cache=cache)
    _close(yt, yj, TOL)
    outs = [yt]
    for t in range(8, 12):
        cache = jax.tree.map(np.asarray, cj)
        (yj, cj), (yt, ct) = _block(setup, x[:, t:t + 1], cache=cache)
        _close(yt, yj, TOL)
        for name in ssm.SLOT_STATE_LEAVES:
            _close(ct[name], cj[name], TOL)
        outs.append(yt)
    (_, _), (y_full, _) = _block(setup, x)
    _close(torch.cat(outs, 1), y_full, TOL)


def test_mamba_block_ragged_chunk_lens_match_jax(setup):
    """A chunk of 5 over a carried state with chunk_lens (5, 2, 0, 1): the
    state a row emits is the state after its last valid token; the idle
    row keeps its state bit for bit."""
    cfg = setup["cfg"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, cfg.d_model)).astype(np.float32)
    cache = _state(cfg, 4, rng, scale=0.5)
    clens = np.array([5, 2, 0, 1], np.int32)
    (yj, cj), (yt, ct) = _block(setup, x, cache=cache, clens=clens)
    for b, n in enumerate(clens):
        _close(yt[b, :n], yj[b, :n], TOL)
    for name in ssm.SLOT_STATE_LEAVES:
        _close(ct[name], cj[name], TOL)
        assert torch.equal(ct[name][2], torch.from_numpy(cache[name][2]))
    # row 1's state is the state after its 2 tokens alone
    (_, c2), (_, c2t) = _block(setup, x[1:2, :2], cache=jax.tree.map(
        lambda a: a[1:2], cache))
    for name in ssm.SLOT_STATE_LEAVES:
        _close(ct[name][1:2], c2t[name], TOL)


def test_mamba_lora_deltas_of_two_adapters_match_jax(setup):
    """mamba_in and mamba_out deltas of two adapters (B != 0), each row on
    its own adapter, with a cache: against JAX, and the deltas move the
    output."""
    cfg = setup["cfg"]
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    cache = _state(cfg, 2, rng, scale=0.5)
    (yj, cj), (yt, ct) = _block(setup, x, cache=cache, lora=True)
    _close(yt, yj, TOL)
    for name in ssm.SLOT_STATE_LEAVES:
        _close(ct[name], cj[name], TOL)
    (_, _), (y0, _) = _block(setup, x, cache=cache)
    assert float((yt - y0).abs().max()) > 1e-3


def test_mamba_flop_tally_matches_jax_at_t_within_a_chunk(setup):
    """The Eq. 5 tally (static and dynamic FLOPs, nonlinear elements) of
    one block with LoRA and a cache, at T = 12 <= chunk 16, equals JAX's
    (``breakdown_of`` traces the block abstractly)."""
    cfg = setup["cfg"]
    assert 12 <= cfg.mamba.chunk
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    cache = _state(cfg, 2, rng)
    idx = np.array([0, 1], np.int32)
    report = jhetero.breakdown_of(
        lambda p, xx, c, lr: jssm.apply_mamba_block(
            setup["jcfg"], p, xx, cache=c, lora=lr,
            adapter_idx=jnp.asarray(idx)),
        setup["jp"], jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
        jax.tree.map(jnp.asarray, setup["lora"]))
    with hetero.tally() as t:
        ssm.apply_mamba_block(cfg, setup["tp"], torch.from_numpy(x),
                              cache=_to_torch(cache), lora=setup["tlora"],
                              adapter_idx=torch.from_numpy(idx).long())
    assert t[hetero.STATIC] == report.static_flops
    assert t[hetero.DYNAMIC] == report.dynamic_flops
    assert t["nonlinear"] == report.nonlinear_elems


def test_init_mamba_layout_matches_jax(setup):
    """init_mamba builds JAX's tree (paths, shapes, dtypes), stacked along
    ``lead``; the deterministic leaves (conv_b, A_log, D) equal JAX's and
    dt_bias is the inverse softplus of a dt in [0.001, 0.1]."""
    cfg = setup["cfg"]
    tp = ssm.init_mamba(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32, lead=(3,))
    jp = setup["jp"]
    assert set(tp) == set(jp)
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == (3, *leaf.shape), name
        assert tp[name].dtype == torch.float32
    for name in ("conv_b", "A_log", "D"):
        for i in range(3):
            np.testing.assert_array_equal(tp[name][i].numpy(),
                                          np.asarray(jp[name]))
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 0.001 * 0.999 and float(dt.max()) <= 0.1001
