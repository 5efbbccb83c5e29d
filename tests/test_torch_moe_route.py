"""The MoE layer's routing, layout and combine (``kernels/moe_route``'s
plain versions, which are what CPU tensors run) against the JAX package's
``repro.models.moe``, and the grouped decode kernel's work list
(``crossbar_matmul/ops.grouped_decode_work_list``, the mirror of the rule
that ``csrc/crossbar_matmul.cu``'s blocks derive on the card).

Reduced llama4-scout (4 experts, top-1, gates not renormalised), mixtral
and jamba (4 experts, top-2, renormalised), at one and two slots an
expert, with pads in ``token_mask``:

  * ``moe_route_plain``'s expert ids and gates against ``jax.lax.top_k``
    of the package's f32 router probabilities, its aux against the
    package's ``apply_moe`` (within 1e-5: f32 on both sides, sums in
    another order), and each slot's buffer order against the package's
    one-hot cumsum rank (a slot's rows hold its tokens in (b, t) order:
    batch row b's rank ``pos`` plus the slot's count in the rows before);
  * ``moe_combine_plain`` over the port's buffer against the package's
    dropless combine (``take_along_axis`` of its C = T-row buffer) on the
    same expert outputs, with the shared expert's rows added;
  * the route kernel's layout (``moe_ops.route_partition``: items of a
    few tokens, counts scanned over the items) against the package's
    cumsum rank, and the plain routing's ties (to the lower expert)
    against ``jax.lax.top_k``'s;
  * the work list at llama4-scout's, mixtral's and jamba's widths for
    8 decode rows on 8 slots, on one slot, and 8 tokens top-2: every live
    (row group, N tile, K tile) exactly once, no padding group, the grid
    fixed by the card alone.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.core import hetero as jhetero
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.kernels.moe_route import ops as moe_ops

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(5)
TOL = 1e-5
ARCHS = ("llama4-scout-17b-a16e", "mixtral-8x22b", "jamba-1.5-large-398b")


@functools.lru_cache(maxsize=None)
def _layer(arch, tpe):
    """(JAX config, JAX weights, port router) of one MoE layer."""
    jcfg = jax_reduce_config(jax_get_config(arch))
    mp = 1 if tpe == 1 else tpe * jcfg.moe.n_experts
    p = jax.jit(functools.partial(jmoe.init_moe, jcfg, dtype=jnp.float32,
                                  moe_parallel=mp))(KEY)
    return jcfg, p, bridge.to_torch(np.asarray(p["router"]), "cpu")


def _inputs(cfg, B=3, T=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 4:] = False                  # a ragged row
    mask[2, 0] = False                   # and a pad in front
    return x, mask


@functools.lru_cache(maxsize=None)
def _jax_routing(arch, tpe):
    """The package's routing of ``_inputs``: probs, top-k ids and gates,
    and dropless apply_moe's aux."""
    jcfg, p, _ = _layer(arch, tpe)
    x, mask = _inputs(jcfg)
    k = jcfg.moe.top_k
    probs = jax.nn.softmax(jhetero.static_matmul(jnp.asarray(x),
                                                 p["router"]), axis=-1)
    gate, eidx = jax.lax.top_k(probs, k)
    if jcfg.moe.router_norm_topk:
        gate = gate / jnp.maximum(jnp.sum(gate, -1, keepdims=True), 1e-9)
    _, aux = jax.jit(functools.partial(jmoe.apply_moe, jcfg,
                                       dispatch="dropless"))(
        p, jnp.asarray(x), token_mask=jnp.asarray(mask))
    return (np.asarray(probs), np.asarray(eidx), np.asarray(gate),
            {k_: float(v) for k_, v in aux.items()})


def _jax_pos(eidx, mask, E, tpe):
    """The package's one-hot cumsum rank of each assignment within its
    (batch row, slot), and its slot ids: (B, T, k * tpe) each."""
    B, T, k = eidx.shape
    sidx = (eidx[..., None] * tpe + np.arange(tpe)).reshape(B, T, k * tpe)
    oh = np.asarray(jax.nn.one_hot(sidx, E * tpe, dtype=jnp.float32))
    oh = oh * mask[:, :, None, None]
    pos = np.cumsum(oh.reshape(B, T * k * tpe, -1), axis=1)
    pos = pos.reshape(oh.shape) - oh
    return (pos * oh).sum(-1).astype(np.int64), sidx


def _route(arch, tpe, tile=8):
    jcfg, _, router = _layer(arch, tpe)
    x, mask = _inputs(jcfg)
    B, T, d = x.shape
    xt = torch.as_tensor(x).reshape(B * T, d)
    logits = torch.matmul(xt, router)
    k, E = jcfg.moe.top_k, jcfg.moe.n_experts
    R = cb_ops.grouped_rows(B * T * k * tpe, E * tpe, tile)
    return moe_ops.moe_route_plain(
        logits, torch.as_tensor(mask).reshape(B * T), xt, top_k=k, tpe=tpe,
        norm_topk=jcfg.moe.router_norm_topk, tile=tile, R=R)


@pytest.mark.parametrize("tpe", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_plain_matches_jax_routing_and_rank(arch, tpe):
    jcfg, _, _ = _layer(arch, tpe)
    x, mask = _inputs(jcfg)
    B, T, _ = x.shape
    k, E = jcfg.moe.top_k, jcfg.moe.n_experts
    probs, eidx, gate, aux = _jax_routing(arch, tpe)
    r = _route(arch, tpe)
    np.testing.assert_array_equal(r.experts.numpy().reshape(B, T, k), eidx)
    np.testing.assert_allclose(r.gate.numpy().reshape(B, T, k), gate,
                               rtol=TOL, atol=TOL)
    top = -np.sort(-probs, -1)
    np.testing.assert_allclose(r.margin.numpy().reshape(B, T),
                               top[..., k - 1] - top[..., k], rtol=TOL,
                               atol=TOL)
    for i, name in enumerate(("lb_loss", "router_z", "dropped_tokens")):
        np.testing.assert_allclose(float(r.aux[i]), aux[name], rtol=TOL,
                                   atol=TOL)
    pos, sidx = _jax_pos(eidx, mask, E, tpe)
    K = k * tpe
    rows = r.rows.numpy().reshape(B, T, K)
    kept = r.weights.numpy().reshape(B, T, K) > 0
    np.testing.assert_array_equal(kept, np.broadcast_to(
        mask[:, :, None], kept.shape))
    counts, bases = r.counts.numpy(), r.bases.numpy()
    # slot s's rows: batch row b's ranks after the rows before b's
    before = np.zeros(E * tpe, np.int64)
    for b in range(B):
        for t in range(T):
            for q in range(K):
                if kept[b, t, q]:
                    s = sidx[b, t, q]
                    assert rows[b, t, q] == bases[s] + before[s] + pos[b, t,
                                                                       q]
        before += np.bincount(sidx[b][kept[b]], minlength=E * tpe)
    np.testing.assert_array_equal(counts, before)
    assert not rows[~kept].any()
    np.testing.assert_array_equal(np.diff(bases), -(-counts // 8) * 8)
    # the buffer: each kept assignment's row is its token's x, others 0
    xb = r.xbuf.numpy()
    src = np.broadcast_to(x[:, :, None, :], (B, T, K, x.shape[-1]))
    np.testing.assert_array_equal(xb[rows[kept]], src[kept])
    live = np.zeros(len(xb), bool)
    live[rows[kept]] = True
    assert not xb[~live].any()


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("tpe", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_combine_plain_matches_jax_combine(arch, tpe, shared):
    jcfg, _, _ = _layer(arch, tpe)
    x, mask = _inputs(jcfg)
    B, T, d = x.shape
    k, E = jcfg.moe.top_k, jcfg.moe.n_experts
    K, slots = k * tpe, E * tpe
    _, eidx, gate, _ = _jax_routing(arch, tpe)
    pos, sidx = _jax_pos(eidx, mask, E, tpe)
    rng = np.random.default_rng(tpe)
    out_e = rng.standard_normal((slots, B, T, d)).astype(np.float32)
    sh = rng.standard_normal((B, T, d)).astype(np.float32)
    # the package's dropless combine (C = T rows a slot and batch row)
    sgate = np.repeat(gate, tpe, axis=-1) * mask[:, :, None]
    flat = sidx * T + pos
    o = jnp.asarray(out_e).transpose(1, 0, 2, 3).reshape(B, slots * T, d)
    sel = jnp.take_along_axis(o, jnp.asarray(flat.reshape(B, T * K))[
        :, :, None], axis=1)
    w = jnp.where(jnp.asarray(sgate > 0), jnp.asarray(sgate), 0.0)
    yj = np.asarray(jnp.sum(sel.reshape(B, T, K, d) * w[..., None], axis=2))
    if shared:
        yj = yj + sh
    # the same expert outputs in the port's buffer
    r = _route(arch, tpe)
    out = np.full((r.xbuf.shape[0], d), np.nan, np.float32)  # never read
    rows = r.rows.numpy().reshape(B, T, K)
    kept = r.weights.numpy().reshape(B, T, K) > 0
    for b, t, q in zip(*np.nonzero(kept)):
        out[rows[b, t, q]] = out_e[sidx[b, t, q], b, pos[b, t, q]]
    y = moe_ops.moe_combine_plain(
        torch.as_tensor(out), r.rows.reshape(B * T, K),
        r.weights.reshape(B * T, K),
        torch.as_tensor(sh).reshape(B * T, d) if shared else None)
    np.testing.assert_allclose(y.numpy().reshape(B, T, d), yj, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("chunk", [2, 5, 8])
@pytest.mark.parametrize("tpe", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_partition_matches_jax_cumsum_rank(arch, tpe, chunk):
    """The route kernel's layout (``moe_ops.route_partition``: tokens dealt
    out in items of ``chunk``, slot counts and ranks by bit masks, the
    counts scanned over the items, the padded bases) over the package's
    routing: rows, bases and counts equal the package's cumsum rank (a
    slot's rows hold batch row b's ranks after the rows before b's)."""
    jcfg, _, _ = _layer(arch, tpe)
    x, mask = _inputs(jcfg)
    B, T, _ = x.shape
    k, E = jcfg.moe.top_k, jcfg.moe.n_experts
    K, slots = k * tpe, E * tpe
    _, eidx, _, _ = _jax_routing(arch, tpe)
    pos, sidx = _jax_pos(eidx, mask, E, tpe)
    kept = np.broadcast_to(mask[:, :, None], (B, T, K))
    part = moe_ops.route_partition(
        torch.as_tensor(sidx.reshape(B * T, K)),
        torch.as_tensor(kept.reshape(B * T, K).copy()),
        slots, 8, chunk)
    assert part["items"] == [(t, min(t + chunk, B * T))
                             for t in range(0, B * T, chunk)]
    assert len(part["items"]) > 2            # the tokens split over items
    counts = np.bincount(sidx[kept], minlength=slots)
    bases = np.concatenate([[0], np.cumsum(-(-counts // 8) * 8)])
    rows = np.zeros((B, T, K), np.int64)
    before = np.zeros(slots, np.int64)
    for b in range(B):
        s = sidx[b][kept[b]]
        rows[b][kept[b]] = bases[s] + before[s] + pos[b][kept[b]]
        before += np.bincount(s, minlength=slots)
    np.testing.assert_array_equal(part["rows"].numpy().reshape(B, T, K),
                                  rows)
    np.testing.assert_array_equal(part["counts"].numpy(), counts)
    np.testing.assert_array_equal(part["bases"].numpy(), bases)
    ic = part["item_counts"].numpy()
    np.testing.assert_array_equal(ic.sum(0), counts)
    np.testing.assert_array_equal(part["offsets"].numpy(),
                                  np.cumsum(ic, 0) - ic)


def test_route_plain_breaks_ties_to_the_lower_expert_as_jax():
    """Exactly tied router probabilities (rows all equal, rows rounded to
    halves): the plain routing's ids and gates are jax.lax.top_k's."""
    rng = np.random.default_rng(3)
    logits = np.round(rng.standard_normal((24, 16)) * 2) / 2
    logits[::4] = 0.0
    logits = logits.astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gate, eidx = jax.lax.top_k(probs, 2)
    lt = torch.as_tensor(logits)
    r = moe_ops.moe_route_plain(lt, None, torch.zeros(24, 4), top_k=2,
                                tpe=1, norm_topk=False, tile=8,
                                R=cb_ops.grouped_rows(48, 16, 8))
    np.testing.assert_array_equal(r.experts.numpy(), np.asarray(eidx))
    np.testing.assert_allclose(r.gate.numpy(), np.asarray(gate), rtol=TOL,
                               atol=TOL)
    assert (r.experts[::4] == torch.tensor([0, 1])).all()


def test_compare_routes_finds_each_difference():
    r = _route("mixtral-8x22b", 1)
    assert moe_ops.compare_routes(r, r)["ok"]
    bad_rows = r._replace(rows=r.rows.roll(1))
    assert moe_ops.compare_routes(bad_rows, r)["layout_equal"] is False
    bad_gate = r._replace(gate=r.gate * (1 + 1e-5))
    assert not moe_ops.compare_routes(bad_gate, r)["ok"]
    kept = r.weights > 0
    xb = r.xbuf.clone()
    xb[r.rows[kept][0]] += 1.0
    assert not moe_ops.compare_routes(r._replace(xbuf=xb), r)["ok"]


# (K, N) of each expert stack and the slots of llama4-scout, mixtral and
# jamba at full width
STACKS = {"llama4-scout-17b-a16e": (16, ((5120, 8192), (8192, 5120))),
          "mixtral-8x22b": (8, ((6144, 16384), (16384, 6144))),
          "jamba-1.5-large-398b": (16, ((8192, 24576), (24576, 8192)))}


def _decode_counts(dist, slots):
    """8 decode tokens: on 8 distinct slots, all on one, or top-2 on
    distinct pairs (chip_smoke.py's grouped cases)."""
    c = np.zeros(slots, np.int64)
    rng = np.random.default_rng(slots)
    if dist == "decode_spread":
        c[rng.permutation(slots)[:8]] = 1
    elif dist == "decode_one":
        c[slots // 2] = 8
    else:
        for _ in range(8):
            c[rng.permutation(slots)[:2]] += 1
    return c


@pytest.mark.parametrize("dist", ["decode_spread", "decode_one",
                                  "decode_top2"])
@pytest.mark.parametrize("arch", sorted(STACKS))
def test_grouped_decode_work_list_covers_each_live_tile_once(arch, dist):
    slots, shapes = STACKS[arch]
    counts = _decode_counts(dist, slots)
    rows = int(counts.sum())
    bases = np.concatenate([[0], np.cumsum(-(-counts // 8) * 8)])
    R = cb_ops.grouped_rows(rows, slots, 8)
    assert bases[-1] <= R
    grid = cb_ops.grouped_decode_grid()
    assert grid == cb_ops.grouped_decode_grid(132) == 4 * 132
    groups = {(s, int(bases[s]) + 8 * g) for s in range(slots)
              for g in range(-(-int(counts[s]) // 8))}
    for K, N in shapes:
        n_nt, n_kt = N // 128, K // 128
        units = cb_ops.grouped_decode_work_list(counts, bases, K, N, grid)
        S = units[0]["S"]
        assert S == cb_ops.grouped_decode_splits(len(groups), N, K, grid)
        assert len(units) == len(groups) * n_nt * S
        assert S == 1 or len(units) <= grid     # splits only fill the grid
        seen = set()
        for u in units:
            s, m0 = u["slot"], u["m0"]
            assert (s, m0) in groups            # a live group, no padding
            assert bases[s] <= m0 < u["live"] == bases[s] + counts[s]
            assert m0 + 8 <= bases[s + 1]
            for kt in u["k_tiles"]:
                key = (m0, u["nt"], kt)
                assert key not in seen
                seen.add(key)
        assert len(seen) == len(groups) * n_nt * n_kt
        # the splits of one tile share its ticket, one tile per (group, nt),
        # adjacent in the order the blocks take them
        tiles = {(u["m0"], u["nt"]): u["tile"] for u in units}
        assert len(set(tiles.values())) == len(tiles)
        assert [u["tile"] for u in units] == sorted(u["tile"] for u in units)
        assert all(u["rank"] == i % S for i, u in enumerate(units))
        # one block each, spread over the grid when the units fit in it
        # (gaps of the same size, give or take one), else the first grid
        # units on blocks 0 .. grid - 1 and the rest on whichever is free
        blocks = [u["block"] for u in units]
        if len(units) <= grid:
            gaps = np.diff(blocks + [grid])
            assert blocks[0] == 0 and gaps.min() >= 1
            assert gaps.max() - gaps.min() <= 1
        else:
            assert blocks[:grid] == list(range(grid))
            assert set(blocks[grid:]) == {None}
    if dist == "decode_one":
        # one live group: the K split comes from it, not the buffer's R / 8
        assert S > 1 and R // 8 > 1
