"""Sliding-window attention, the ring caches and the gated GELU in the port
(CPU, plain kernel versions) against the JAX package, at the reduced
gemma2-9b (two layers, one sliding and one global, window 8, head_dim 16,
softcap 50, a gated GELU MLP), with the JAX weights carried across by
``repro_torch.bridge``:

  * ``attend(kind="sliding")`` (port ``ref`` and ``auto``) against JAX
    ``attend`` with ``impl="ref"`` and ``impl="pallas"`` (interpret mode),
    window < S, softcap, GQA, D 16 and D 256, and JAX's "no window unless
    sliding and narrower than S" rule;
  * the ring branch of ``paged_attend`` against JAX ``_paged_attend``:
    decode on a wrapped ring, T < W, T = W, T > W, ragged chunk lengths
    with an empty row, a fresh slot; outputs within 1e-5, the ring after
    the write-back bit-equal;
  * the gated GELU MLP, and reduced gemma2 ``forward`` (prefill past the
    window, then decode over the ring) against JAX's logits and caches,
    with the FLOP tallies;
  * the paged chunked forward against the dense one
    (``tests/test_paged_cache.py``), and ``PagedServeEngine`` greedy
    tokens against ``tests/oracle.replay_greedy``: under preemption with
    the prefix cache off, with n-gram speculation, and with an always-wrong
    drafter that rolls the rings back (and a second wave on the recycled
    slots), as ``tests/test_spec_decode.py`` runs them on the JAX engine;
  * ``SlotStateArena`` tracks the rings as the JAX arena does.

Tolerances: 1e-5 on attention outputs (f32 softmax summed in another
order, observed ~1e-7), 1e-4 on logits (as ``tests/test_torch_model.py``).
Every JAX call here is jitted: eagerly, each of its ops compiles anew for
every shape (~7 s a forward at this size). That includes the oracle,
whose ``transformer.forward`` is swapped for a jitted one while this
module's fixture holds it; every prompt has the same length (12, past the
window), and the oracle is computed once per (prompt, adapter).
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import replay_greedy

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.core import hetero as jhetero
from repro.core import lora as jlora
from repro.models import attention as jattn
from repro.models import kvcache as jkvcache
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import hetero, lora
from repro_torch.models import attention, kvcache, layers
from repro_torch.models import transformer as tfm
from repro_torch.serve.api import Request, make_engine
from repro_torch.serve.spec import SpecConfig

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
ATTN_TOL = 1e-5
TOL = 1e-4
N_NEW = 5
PROMPT_LEN = 12
PROMPTS = [np.random.default_rng(s).integers(0, 257, PROMPT_LEN)
           .astype(np.int32) for s in range(3)]


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


@functools.lru_cache(maxsize=None)
def _jitted(fn, **static):
    return jax.jit(functools.partial(fn, **static))


# the keyword arguments of transformer.forward that shape its trace
_STATIC = ("mode", "prefill_cache_len", "exec_cfg")


@functools.lru_cache(maxsize=None)
def _forward_of(cfg, static):
    return jax.jit(lambda params, inputs, **kw: _FORWARD(
        cfg, params, inputs, **dict(static), **kw))


def _jit_forward(cfg, params, inputs, **kw):
    """``jtfm.forward`` jitted per (cfg, static keywords)."""
    static = tuple((k, kw.pop(k)) for k in _STATIC if k in kw)
    return _forward_of(cfg, static)(params, inputs, **kw)


_FORWARD = jtfm.forward


@pytest.fixture(scope="module")
def gemma():
    jcfg = jax_reduce_config(jax_get_config("gemma2-9b"))
    params = jax.jit(functools.partial(jtfm.init_params, jcfg))(KEY)
    ad0 = jax.jit(functools.partial(jlora.init_lora_params, jcfg))(
        jax.random.fold_in(KEY, 1))
    ad1 = jax.tree.map(lambda x: x + 0.3, ad0)
    memo = {}

    def expected(i, adapter_id, max_len=48):
        if (i, adapter_id) not in memo:
            memo[(i, adapter_id)] = replay_greedy(
                jcfg, params, [ad0, ad1], PROMPTS[i], N_NEW,
                adapter_id=adapter_id, max_len=max_len)
        return memo[(i, adapter_id)]

    jtfm.forward = _jit_forward         # the oracle's forward, jitted
    try:
        yield SimpleNamespace(
            jcfg=jcfg, cfg=reduce_config(get_config("gemma2-9b")),
            jparams=params, params=_to_torch(params), jads=[ad0, ad1],
            adapters=[_to_torch(ad0), _to_torch(ad1)], expected=expected)
    finally:
        jtfm.forward = _FORWARD


# ---------------------------------------------------------------------------
# attend: the window rule, ref and the flash wrapper's plain version
# ---------------------------------------------------------------------------

# (label, B, T, S, Hq, Hkv, D, window): prefill over its own keys with a
# ragged row, and a chunk over a longer context
ATTEND_CASES = [("d16_prefill", 2, 12, 12, 4, 2, 16, 5),
                ("d16_chunk", 2, 4, 20, 4, 2, 16, 8),
                ("d256", 1, 6, 10, 2, 1, 256, 4)]


@pytest.mark.parametrize("impl", ["ref", "auto"])
@pytest.mark.parametrize("case", ATTEND_CASES, ids=[c[0] for c in ATTEND_CASES])
def test_attend_sliding_matches_jax_ref_and_pallas(case, impl):
    _, B, T, S, Hq, Hkv, D, window = case
    rng = np.random.default_rng(S * D)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    qpos = np.broadcast_to(np.arange(S - T, S), (B, T)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32).copy()
    kpos[1:, S - 2:] = -1               # a ragged row: its tail is padding
    qpos = np.minimum(qpos, np.where(kpos >= 0, kpos, 0).max(1)[:, None])
    jargs = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    targs = [torch.from_numpy(np.ascontiguousarray(a))
             for a in (q, k, v, qpos, kpos)]
    kw = dict(kind="sliding", window=window, softcap=50.0)
    out = attention.attend(*targs, impl=impl, **kw)
    for jimpl in ("ref", "pallas"):
        ref = _jitted(jattn.attend, impl=jimpl, block_q=2048, block_kv=512,
                      **kw)(*jargs)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)
    # a full layer ignores the window: JAX's ref
    kw["kind"] = "full"
    ref = _jitted(jattn.attend, impl="ref", block_q=2048, block_kv=512,
                  **kw)(*jargs)
    full = attention.attend(*targs, impl=impl, **kw)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    assert float((full - out).abs().max()) > 1e-3     # the window masked
    assert attention._window("sliding", window, S) == window
    assert attention._window("sliding", S, S) is None
    assert attention._window("full", window, S) is None


# ---------------------------------------------------------------------------
# the paged ring branch against JAX's _paged_attend
# ---------------------------------------------------------------------------

# (label, T, lens, chunk_lens) at W = 8: decode on wrapped rings; a chunk
# as wide as the ring (rows shorter than it, an empty row, a fresh slot);
# a chunk wider than the ring (rows longer than it, a fresh slot)
RING_CASES = [("decode_wrapped", 1, (20, 9, 31), (1, 1, 1)),
              ("t_eq_w", 8, (6, 16, 0, 14), (8, 5, 3, 0)),
              ("t_gt_w", 13, (2, 9, 0), (13, 11, 6))]


@pytest.mark.parametrize("case", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_ring_paged_attend_matches_jax(gemma, case):
    """Port ``ref`` and ``auto`` against JAX ``_paged_attend``."""
    _, T, lens, clens = case
    cfg, jcfg = gemma.cfg, gemma.jcfg
    W, Hkv, D = cfg.attn.window, cfg.n_kv_heads, cfg.hd
    B = len(lens)
    rng = np.random.default_rng(T + sum(lens))
    ring_k, ring_v = (rng.standard_normal((B, Hkv, W, D)).astype(np.float32)
                      for _ in range(2))
    q = rng.standard_normal((B, T, cfg.n_heads, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
            for _ in range(2))
    lens, clens = np.asarray(lens, np.int32), np.asarray(clens, np.int32)
    pos = (lens[:, None] + np.arange(T)[None]).astype(np.int32)
    paged_attend = _jitted(jattn._paged_attend, cfg=jcfg, kind="sliding",
                           softcap=cfg.attn.logit_softcap, impl="ref",
                           block_q=2048, block_kv=512, sharder=None)
    jout, jring = paged_attend(
        q=jnp.asarray(q), k=jnp.asarray(k), v=jnp.asarray(v),
        positions=jnp.asarray(pos),
        cache={"k": jnp.asarray(ring_k), "v": jnp.asarray(ring_v)},
        paged={"block_table": jnp.zeros((B, 1), jnp.int32),
               "lens": jnp.asarray(lens), "chunk_lens": jnp.asarray(clens),
               "page_size": 4})
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    valid = np.arange(T)[None] < clens[:, None]    # pad rows are discarded
    for impl in ("ref", "auto"):
        ring = {"k": t(ring_k).clone(), "v": t(ring_v).clone()}
        out = attention.paged_attend(
            cfg, t(q), t(k), t(v), t(pos), ring,
            {"block_table": torch.zeros((B, 1), dtype=torch.int32),
             "lens": t(lens), "chunk_lens": t(clens), "page_size": 4},
            kind="sliding", softcap=cfg.attn.logit_softcap, impl=impl)
        np.testing.assert_allclose(out.numpy()[valid],
                                   np.asarray(jout)[valid], rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
        for name in ("k", "v"):
            np.testing.assert_array_equal(ring[name].numpy(),
                                          np.asarray(jring[name]))


def test_ring_write_targets_repeat_one_real_write():
    """Rows that do not write (padding, tokens a later one overwrites)
    repeat the first writing row's (row, slot), so duplicate indices carry
    one value."""
    pos = torch.tensor([[5, 6, 7, 8, 9, 10], [0, 1, 2, 3, 4, 5]])
    clens = torch.tensor([6, 0])
    src, rows, slots = attention.ring_write_targets(pos, clens, 4)
    writes = {(int(r), int(s)): int(i) for r, s, i in zip(rows, slots, src)}
    # row 0 writes positions 7..10 (t = 2..5) into slots 3, 0, 1, 2
    assert writes == {(0, 3): 2, (0, 0): 3, (0, 1): 4, (0, 2): 5}
    assert set(src.tolist()) == {2, 3, 4, 5}


# ---------------------------------------------------------------------------
# the gated GELU, the model
# ---------------------------------------------------------------------------


def test_gated_gelu_mlp_matches_jax(gemma):
    jcfg, cfg = gemma.jcfg, gemma.cfg
    p = jlayers.init_mlp(jcfg, jax.random.fold_in(KEY, 9), jnp.float32)
    assert sorted(p) == ["w1", "w2", "w3"]
    x = np.random.default_rng(2).standard_normal((3, 5, cfg.d_model)).astype(
        np.float32)
    with jhetero.tally() as jt:
        yj = jlayers.apply_mlp(jcfg, p, jnp.asarray(x))
    with hetero.tally() as t:
        yt = layers.apply_mlp(cfg, _to_torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    assert t["nonlinear"] == jt["nonlinear"] == 3 * 5 * cfg.d_ff
    # the port draws w1, w3, w2 in that order, at JAX's shapes
    mine = layers.init_mlp(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    assert list(mine) == ["w1", "w3", "w2"]
    assert all(tuple(mine[n].shape) == p[n].shape for n in mine)


def test_forward_past_the_window_then_decode_matches_jax(gemma):
    """Three rows on their own adapters: a 14-token prefill (past the
    window of 8) into a 24-position cache, then 2 decode steps over the
    ring; logits, ring and lengths against JAX, and the FLOP tallies of the
    prefill with the JAX forward unrolled."""
    jcfg, cfg = gemma.jcfg, gemma.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (3, 14)).astype(np.int32)
    idx = np.array([1, 0, 1])
    jkw = dict(lora=jlora.stack_adapters(gemma.jads),
               adapter_idx=jnp.asarray(idx))
    tkw = dict(lora=lora.stack_adapters(gemma.adapters),
               adapter_idx=torch.as_tensor(idx))

    def jfwd(p):
        return _FORWARD(jcfg, p, {"tokens": jnp.asarray(toks)},
                        mode="prefill", prefill_cache_len=24,
                        exec_cfg=jtfm.ExecConfig(scan_layers=False), **jkw)

    lj, cj, _ = _jit_forward(jcfg, gemma.jparams,
                             {"tokens": jnp.asarray(toks)}, mode="prefill",
                             prefill_cache_len=24, **jkw)
    with hetero.tally() as t:
        lt, ct, _ = tfm.forward(cfg, gemma.params,
                                {"tokens": torch.as_tensor(toks)},
                                mode="prefill", prefill_cache_len=24, **tkw)
    report = jhetero.breakdown_of(lambda p: jfwd(p)[0], gemma.jparams)
    assert t[hetero.STATIC] == report.static_flops
    assert t[hetero.DYNAMIC] == report.dynamic_flops
    assert t["nonlinear"] == report.nonlinear_elems
    for _ in range(3):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                                   atol=TOL)
        for te, je in zip(ct["layers"], cj["layers"]):
            assert set(te) == set(je)
            for n in te:
                assert tuple(te[n].shape) == je[n].shape, n
                np.testing.assert_allclose(te[n].numpy(), np.asarray(je[n]),
                                           rtol=TOL, atol=TOL)
        nxt = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
        lj, cj, _ = _jit_forward(jcfg, gemma.jparams,
                                 {"tokens": jnp.asarray(nxt)}, mode="decode",
                                 cache=cj, **jkw)
        lt, ct, _ = tfm.forward(cfg, gemma.params,
                                {"tokens": torch.as_tensor(nxt)},
                                mode="decode", cache=ct, **tkw)
    # the sliding position's cache is a ring of W slots
    assert ct["layers"][0]["k"].shape[3] == cfg.attn.window
    assert ct["layers"][1]["k"].shape[3] == 24


def test_paged_chunked_forward_matches_dense(gemma):
    """``tests/test_paged_cache.py``'s check in the port: one prompt
    through dense prefill + decode and through the paged path in ragged
    chunks of 4 padded to 6; the last token's logits agree."""
    cfg, params = gemma.cfg, gemma.params
    prompt = torch.tensor([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], dtype=torch.int32)
    L = len(prompt)
    lg, cache, _ = tfm.forward(cfg, params, {"tokens": prompt[None]},
                               mode="prefill", prefill_cache_len=32)
    lg_ref, _, _ = tfm.forward(cfg, params, {"tokens": torch.tensor([[7]])},
                               mode="decode", cache=cache)
    layout = kvcache.PagedLayout(page_size=4, num_pages=12, max_slots=1)
    pcache = kvcache.init_paged_cache(cfg, layout, 32, device="cpu")
    table = torch.full((1, layout.blocks_for(32)), -1, dtype=torch.int32)
    table[0, :layout.blocks_for(L + 1)] = torch.arange(
        layout.blocks_for(L + 1), dtype=torch.int32)

    def run_chunk(toks, lens, width):
        tk = torch.zeros((1, width), dtype=torch.int32)
        tk[0, :len(toks)] = toks
        clen = torch.tensor([len(toks)], dtype=torch.int32)
        return tfm.forward(
            cfg, params, {"tokens": tk}, mode="decode", cache=pcache,
            positions=(lens + torch.arange(width, dtype=torch.int32))[None],
            paged={"block_table": table,
                   "lens": torch.tensor([lens], dtype=torch.int32),
                   "chunk_lens": clen, "page_size": 4},
            chunk_lens=clen)[0]

    lens = 0
    for start in range(0, L, 4):
        chunk = prompt[start:start + 4]
        lg_pg = run_chunk(chunk, lens, 6)
        lens += len(chunk)
    lg_pg2 = run_chunk(torch.tensor([7]), lens, 1)
    np.testing.assert_allclose(lg_pg[0, len(chunk) - 1].numpy(),
                               lg[0, -1].numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lg_pg2[0, 0].numpy(), lg_ref[0, -1].numpy(),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# serving: greedy tokens against the replay oracle
# ---------------------------------------------------------------------------


def _submit(eng, wave=0):
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(uid=100 * wave + i, prompt=p,
                           max_new_tokens=N_NEW, adapter_id=i % 2))


def test_paged_engine_matches_oracle_under_preemption(gemma):
    """Pages of 3 in a pool of 10: two requests are admitted at 5 pages
    each (prompt and first token) and the younger is preempted when the
    older grows to a sixth, then recomputed; chunks of 5 cross the ring's
    end. The prefix cache is off (a ring is per slot)."""
    eng = make_engine(gemma.cfg, gemma.params, gemma.adapters, mode="paged",
                      device="cpu", max_slots=2, max_len=48, page_size=3,
                      num_pages=10, prefill_chunk=5, record_logits=True)
    assert eng.prefix is None and eng.arena.tracked
    _submit(eng)
    done = eng.run_until_done()
    for i in range(len(PROMPTS)):
        assert done[i].generated == gemma.expected(i, i % 2), i
        rows = torch.stack(eng.sampled_logits[i])
        assert rows.argmax(-1).tolist() == done[i].generated
    assert eng.stats().scheduler.preemptions >= 1
    assert eng.sched.alloc.used_pages == 0


def test_spec_ngram_matches_oracle(gemma):
    eng = make_engine(gemma.cfg, gemma.params, gemma.adapters, mode="paged",
                      device="cpu", max_slots=3, max_len=48, page_size=8,
                      prefill_chunk=8, spec=SpecConfig(k=4, drafter="ngram"))
    _submit(eng)
    done = eng.run_until_done()
    for i in range(len(PROMPTS)):
        assert done[i].generated == gemma.expected(i, i % 2), i
    st = eng.stats()
    assert st.spec.rolled_back_tokens == (st.spec.drafted_tokens
                                          - st.spec.accepted_tokens)


class _WrongDrafter:
    """Proposes k constant tokens every call, so most verify chunks reject
    mid-way (``tests/test_spec_decode.py::_WrongDrafter``)."""

    def __init__(self, k, tok=7):
        self.k, self.tok = k, tok

    def propose(self, streams, adapter_ids, k):
        return [np.full(min(k, self.k), self.tok, np.int32) for _ in streams]


def test_ring_rollback_and_slot_recycling_match_oracle(gemma):
    """An always-wrong drafter makes nearly every verify chunk restore the
    rings from the snapshot; a second wave reuses the recycled slots (the
    arena zeroes them at admission)."""
    eng = make_engine(gemma.cfg, gemma.params, gemma.adapters, mode="paged",
                      device="cpu", max_slots=2, max_len=48, page_size=8,
                      prefill_chunk=8, spec=SpecConfig(k=3, drafter="ngram"))
    eng.drafter = _WrongDrafter(k=3)
    for wave in range(2):
        _submit(eng, wave)
        done = eng.run_until_done()
        for i in range(len(PROMPTS)):
            assert done[100 * wave + i].generated == gemma.expected(
                i, i % 2), (wave, i)
    st = eng.stats()
    assert st.spec.recurrent_rollbacks >= 1
    assert not st.prefix_cache.enabled
    assert eng.sched.alloc.used_pages == 0


def test_slot_state_arena_tracks_the_rings_as_jax(gemma):
    lay = kvcache.PagedLayout(page_size=4, num_pages=4, max_slots=3)
    cache = kvcache.init_paged_cache(gemma.cfg, lay, 16, device="cpu")
    jcache = jkvcache.init_paged_cache(
        gemma.jcfg, jkvcache.PagedLayout(page_size=4, num_pages=4,
                                         max_slots=3), 16)
    for te, je in zip(cache["layers"], jcache["layers"]):
        assert {n: tuple(x.shape) for n, x in te.items()} == {
            n: x.shape for n, x in je.items()}
    arena = kvcache.SlotStateArena(gemma.cfg)
    assert arena.leaves == jkvcache.SlotStateArena(gemma.jcfg).leaves
    assert arena.leaves == (("k", "v"), ())
    cache["layers"][0]["k"].fill_(1.0)
    kvcache.reset_slots(cache, [1])
    assert float(cache["layers"][0]["k"][:, 1].abs().sum()) == 0.0
    assert float(cache["layers"][0]["k"][:, 0].sum()) > 0.0
