"""Mixture-of-experts in the port (CPU, plain kernel versions) against the
JAX package's ``repro.models.moe``, at reduced llama4-scout (4 experts,
top-1, a shared expert, gates not renormalised) and reduced mixtral (4
experts, top-2, gates renormalised), with the JAX weights carried across
by ``repro_torch.bridge``:

  * ``apply_moe`` in both dispatch modes, with and without a token mask
    and a routing group size, at ``moe_parallel`` 1 (slots = experts) and
    2E (two slots per expert, whose ``w2`` halves sum), on f32 and M8F8
    expert stacks: outputs within 1e-5, the aux values within 1e-5, and
    capacity mode's dropped count equal to JAX's;
  * ``_capacity`` at the boundary of ``tests/test_moe.py``, ``ref_moe``,
    the shared expert at a capacity that drops every routed token;
  * the compact buffer (``expert_layout``) and
    ``grouped_crossbar_matmul_plain`` (int8 and int4) against JAX's
    dequantize-then-einsum over its C-row buffer, with every row past a
    slot's count 0;
  * the FLOP tally of an MoE forward against JAX's (unrolled), in both
    dispatch modes.

Every JAX call is jitted (eagerly each op compiles anew per shape).
Tolerance 1e-5: f32 on both sides, sums in another order.
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
from repro.core import quant as jquant
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import hetero, quant
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.models import moe
from repro_torch.models import transformer as tfm

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(3)
TOL = 1e-5
ARCHS = ("llama4-scout-17b-a16e", "mixtral-8x22b")


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _cfgs(arch):
    return (jax_reduce_config(jax_get_config(arch)),
            reduce_config(get_config(arch)))


@functools.lru_cache(maxsize=None)
def _weights(arch, moe_parallel, bits):
    """One MoE layer's weights (JAX tree, port tree); ``bits`` 8 quantizes
    the expert stacks (M8F8: the router stays f32)."""
    jcfg, _ = _cfgs(arch)
    p = jax.jit(functools.partial(jmoe.init_moe, jcfg, dtype=jnp.float32,
                                  moe_parallel=moe_parallel))(KEY)
    if bits < 16:
        p = {k: (jquant.quantize(v, bits) if k in ("w1", "w2", "w3") else v)
             for k, v in p.items()}
    return p, _to_torch(p)


def _inputs(cfg, B=2, T=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    # a ragged mask: row 1 holds 5 real tokens, then pads
    mask = np.ones((B, T), bool)
    mask[1, 5:] = False
    return x, mask


@functools.lru_cache(maxsize=None)
def _jax_apply(arch, dispatch, group_size, capacity_factor, masked):
    jcfg, _ = _cfgs(arch)
    fn = functools.partial(jmoe.apply_moe, jcfg, dispatch=dispatch,
                           group_size=group_size,
                           capacity_factor=capacity_factor)
    if masked:
        return jax.jit(lambda p, x, m: fn(p, x, token_mask=m))
    return jax.jit(lambda p, x, m: fn(p, x))


# (label, dispatch, group_size, capacity_factor, token mask)
CASES = [("dropless", "dropless", None, None, False),
         ("dropless_masked_groups", "dropless", 4, None, True),
         ("capacity_masked_groups", "capacity", 4, None, True),
         ("capacity_tight", "capacity", None, 0.5, True)]


@pytest.mark.parametrize("bits", [16, 8], ids=["f32", "m8f8"])
@pytest.mark.parametrize("tpe", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_apply_moe_matches_jax(case, arch, tpe, bits):
    _, dispatch, gs, cf, masked = case
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(arch, 1 if tpe == 1 else 2 * jcfg.moe.n_experts, bits)
    assert moe.live_slots(tp["w1"]) == tpe * cfg.moe.n_experts
    x, mask = _inputs(cfg)
    yj, auxj = _jax_apply(arch, dispatch, gs, cf, masked)(
        jp, jnp.asarray(x), jnp.asarray(mask))
    yt, auxt = moe.apply_moe(
        cfg, tp, torch.as_tensor(x), dispatch=dispatch, group_size=gs,
        capacity_factor=cf,
        token_mask=torch.as_tensor(mask) if masked else None)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL,
                               atol=TOL)
    for k in ("lb_loss", "router_z"):
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]), rtol=TOL,
                                   atol=TOL)
    assert float(auxt["dropped_tokens"]) == float(auxj["dropped_tokens"])
    if dispatch == "dropless":
        assert float(auxt["dropped_tokens"]) == 0.0
    if case[0] == "capacity_tight":
        assert float(auxt["dropped_tokens"]) > 0      # capacity really binds


def test_capacity_exact_ceil_boundary():
    """The boundary of ``tests/test_moe.py``: exact integer ceil."""
    _, cfg = _cfgs("mixtral-8x22b")
    for args, want in (((4001, 1, 2000, 1.0), 3), ((4000, 1, 2000, 1.0), 2),
                       ((16, 2, 8, 1.0), 4), ((16, 1, 8, 1e-9), 1)):
        assert moe._capacity(cfg, *args) == want
        assert jmoe._capacity(_cfgs("mixtral-8x22b")[0], *args) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_ref_moe_matches_jax_and_apply_moe(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(arch, 1, 16)
    x, _ = _inputs(cfg, seed=1)
    yj = jax.jit(functools.partial(jmoe.ref_moe, jcfg))(jp, jnp.asarray(x))
    yt = moe.ref_moe(cfg, tp, torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL,
                               atol=TOL)
    ya, _ = moe.apply_moe(cfg, tp, torch.as_tensor(x), dispatch="dropless")
    np.testing.assert_allclose(ya.numpy(), yt.numpy(), rtol=TOL, atol=TOL)


def test_shared_expert_survives_every_drop():
    """At a capacity factor that drops all but one token per slot, the
    shared expert still adds to every token, as in JAX."""
    jcfg, cfg = _cfgs("llama4-scout-17b-a16e")
    jp, tp = _weights("llama4-scout-17b-a16e", 1, 16)
    x, _ = _inputs(cfg, seed=5)
    yj, _ = _jax_apply("llama4-scout-17b-a16e", "capacity", None, 1e-9,
                       False)(jp, jnp.asarray(x), None)
    yt, aux = moe.apply_moe(cfg, tp, torch.as_tensor(x), capacity_factor=1e-9)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL,
                               atol=TOL)
    assert float(aux["dropped_tokens"]) > 0
    assert float(torch.mean(torch.abs(yt))) > 1e-4
    no_shared = {k: v for k, v in tp.items() if k != "shared"}
    cfg_ns = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, shared_expert=False))
    y0, _ = moe.apply_moe(cfg_ns, no_shared, torch.as_tensor(x),
                          capacity_factor=1e-9)
    assert bool((yt - y0).abs().amin(-1).gt(0).all())


@pytest.mark.parametrize("bits", [8, 4])
def test_grouped_plain_matches_jax_dequantize_einsum(bits):
    """The compact buffer of a routing with an empty slot and a slot of
    many rows, through ``grouped_crossbar_matmul_plain`` (both kernels'
    row tiles), against JAX's dequantize-then-einsum over its C-row
    buffer; every row past a slot's count is 0."""
    slots, K, N, B, T = 4, 256, 384, 2, 6
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((slots, K, N)).astype(np.float32) / 16
    jq = jquant.quantize(jnp.asarray(w), bits)
    tq = _to_torch(jq)
    # slot 2 holds nothing, slot 0 most rows
    sidx = rng.choice([0, 0, 0, 1, 3], size=(B, T)).astype(np.int64)
    x = rng.standard_normal((B, T, K)).astype(np.float32)
    # JAX layout: C = T rows per slot, rank within (b, slot)
    xin = np.zeros((slots, B, T, K), np.float32)
    pos = np.zeros((B, slots), np.int64)
    for b in range(B):
        for t in range(T):
            s = sidx[b, t]
            xin[s, b, pos[b, s]] = x[b, t]
            pos[b, s] += 1
    ref = np.asarray(jnp.einsum("sbcd,sdf->sbcf", jnp.asarray(xin),
                                jquant.dequantize(jq, jnp.float32)))
    for kernel, tile in cb_ops.GROUPED_TILE.items():
        A = B * T
        R = cb_ops.grouped_rows(A, slots, tile)
        rows, bases, counts = moe.expert_layout(
            torch.as_tensor(sidx.reshape(A)), torch.ones(A, dtype=torch.bool),
            slots, tile)
        assert counts.tolist() == [int((sidx == s).sum()) for s in
                                   range(slots)]
        assert int(bases[-1]) <= R and all(int(b) % tile == 0 for b in bases)
        xbuf = torch.full((R, K), float("nan"))   # unwritten rows: never read
        xbuf[rows] = torch.as_tensor(x.reshape(A, K))
        y = cb_ops.grouped_crossbar_matmul(xbuf, tq, bases, counts, kernel)
        live = torch.zeros(R, dtype=torch.bool)
        live[rows] = True
        assert bool((y[~live] == 0).all())
        # each assignment's row against its JAX buffer row
        seen = np.zeros((B, slots), np.int64)
        for a in range(A):
            b, t = divmod(a, T)
            s = sidx[b, t]
            np.testing.assert_allclose(y[rows[a]].numpy(),
                                       ref[s, b, seen[b, s]], rtol=TOL,
                                       atol=TOL)
            seen[b, s] += 1


@pytest.mark.parametrize("dispatch", ["capacity", "dropless"])
def test_flop_tally_matches_jax(dispatch):
    """The Eq. 5 tally of a reduced llama4-scout train forward on an M8F8
    base, against JAX's unrolled ``breakdown_of``."""
    jcfg, cfg = _cfgs("llama4-scout-17b-a16e")
    params = jax.jit(functools.partial(jtfm.init_params, jcfg))(KEY)
    from repro.configs.base import QuantConfig as JaxQuantConfig
    params = jquant.quantize_params(params, JaxQuantConfig(8, 8), min_size=1)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8))
    jec = jtfm.ExecConfig(scan_layers=False, moe_dispatch=dispatch)

    def jfwd(p):
        return jtfm.forward(jcfg, p, {"tokens": jnp.asarray(toks)},
                            exec_cfg=jec)[0]

    report = jhetero.breakdown_of(jfwd, params)
    with hetero.tally() as t:
        lt, _, _ = tfm.forward(cfg, _to_torch(params),
                               {"tokens": torch.as_tensor(toks)},
                               exec_cfg=tfm.ExecConfig(moe_dispatch=dispatch))
    np.testing.assert_allclose(lt.numpy(), np.asarray(jax.jit(jfwd)(params)),
                               rtol=1e-4, atol=1e-4)
    assert t[hetero.STATIC] == report.static_flops
    assert t[hetero.DYNAMIC] == report.dynamic_flops
    assert t["nonlinear"] == report.nonlinear_elems
    assert quant.is_quantized(_to_torch(params)["layers"][0]["ff"]["w1"])
