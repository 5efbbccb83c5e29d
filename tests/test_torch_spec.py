"""Speculative decoding in the port (CPU, plain kernel versions) against the
JAX package, mirroring what the port can run of ``tests/test_spec_decode.py``
and ``tests/test_engine_api.py``'s n-gram tests:

  * the n-gram drafter equals JAX's and its own ``propose_ref`` on seeded
    random streams, degenerate ones included (``test_ngram_*``);
  * ``verify_accept`` at temperature 0 gives JAX's ``emit`` and ``n_emit``
    on seeded logits; at temperature 1 a seeded statistical check of the
    acceptance frequency against ``p(d)`` and of the correction's
    distribution against ``p`` without ``d``;
  * spec greedy tokens (n-gram and quantized self-draft) equal
    ``tests/oracle.replay_greedy`` on reduced llama3.2-1b: plain, under
    preemption, composed with prefix sharing, and with rejections in the
    middle of a verify chunk; on reduced rwkv6-7b with recurrent rollbacks
    (an always-wrong drafter) and slot recycling, and under preemption;
  * ``SlotStateArena.snapshot``/``restore``/``reset`` equal JAX's;
  * ``PageScheduler.rollback`` frees only wholly rejected pages, spares a
    co-holder's, and the refcounts drain to zero under random traffic;
  * the launcher's ``--spec-decode`` on the CPU.

The JAX oracle runs its forward eagerly, about a second a token, and its
cost dominates the file: every prompt here is 8 tokens long and comes from
one list, and the oracle is computed once per (prompt, adapter) for
``N_NEW`` tokens, each test reading a prefix of them."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import replay_greedy

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.models import kvcache as jkvcache
from repro.models import transformer as jtfm
from repro.serve import sampling as jsampling
from repro.serve import spec as jspec
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import lora
from repro_torch.launch import serve as launch_serve
from repro_torch.models import kvcache
from repro_torch.models import transformer as tfm
from repro_torch.serve.api import Request, make_engine
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.scheduler import PageScheduler
from repro_torch.serve.spec import (NGramDrafter, QuantSelfDrafter,
                                    SpecConfig, verify_accept)

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
MAX_LEN = 64
N_NEW = 6

# prompts with internal repetition so the n-gram drafter fires, all of 8
# tokens; request i takes adapter i % 2, so prompts 0 and 4 (adapter 0)
# share a 6-token head
PROMPTS = [np.array([1, 2, 3, 1, 2, 3, 1, 2]),
           np.array([5, 5, 5, 5, 5, 5, 5, 5]),
           np.array([9, 8, 7, 9, 8, 7, 9, 8]),
           np.array([7, 3, 7, 3, 7, 3, 9, 9]),
           np.array([1, 2, 3, 1, 2, 3, 4, 5])]
PROMPTS = [p.astype(np.int32) for p in PROMPTS]


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _model(arch):
    """Reduced ``arch`` with f32 JAX weights (the self-drafter quantizes
    them itself), two adapters, the port's copies, and a memoized oracle at
    ``MAX_LEN`` (the length cap is never reached: each caller's prompts
    and tokens stay below its own ``max_len - 1``)."""
    jcfg = jax_reduce_config(jax_get_config(arch))
    params = jtfm.init_params(jcfg, KEY)
    ad0 = jlora.init_lora_params(jcfg, jax.random.fold_in(KEY, 1))
    ad1 = jax.tree.map(lambda x: x + 0.3, ad0)
    memo = {}

    def expected(prompt, adapter_id, n_new, max_len):
        # greedy tokens for fewer new tokens are a prefix of N_NEW's
        assert n_new <= N_NEW and len(prompt) + n_new < max_len - 1
        key = (tuple(int(t) for t in prompt), adapter_id)
        if key not in memo:
            memo[key] = replay_greedy(jcfg, params, [ad0, ad1], prompt,
                                      N_NEW, adapter_id=adapter_id,
                                      max_len=MAX_LEN)
        return memo[key][:n_new]

    return SimpleNamespace(cfg=reduce_config(get_config(arch)),
                           params=_to_torch(params),
                           adapters=[_to_torch(ad0), _to_torch(ad1)],
                           jcfg=jcfg, jparams=params, jads=[ad0, ad1],
                           expected=expected)


@pytest.fixture(scope="module")
def llama():
    return _model("llama3.2-1b")


@pytest.fixture(scope="module")
def rwkv():
    return _model("rwkv6-7b")


def _serve(m, prompts, n_new, *, drafter=None, **engine_kw):
    eng = make_engine(m.cfg, m.params, m.adapters, mode="paged",
                      device="cpu", record_logits=True, **engine_kw)
    if drafter is not None:
        eng.drafter = drafter
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=n_new,
                           adapter_id=i % 2))
    done = eng.run_until_done()
    assert sorted(done) == list(range(len(prompts)))
    for i, p in enumerate(prompts):
        assert done[i].generated == m.expected(p, i % 2, n_new,
                                               engine_kw["max_len"]), i
        # each token's recorded logits row is the row it came from
        rows = torch.stack(eng.sampled_logits[i])
        assert rows.argmax(-1).tolist() == done[i].generated
    st = eng.stats()
    assert st.spec.rolled_back_tokens == (st.spec.drafted_tokens
                                          - st.spec.accepted_tokens)
    eng.release_prefix_cache()
    assert eng.sched.alloc.used_pages == 0
    eng.sched.alloc.check_invariants()
    return eng, st


class _WrongDrafter:
    """Proposes k constant tokens every call, so most verify chunks reject
    mid-way (mirrors ``tests/test_spec_decode.py::_WrongDrafter``)."""

    def __init__(self, k, tok=7):
        self.k, self.tok = k, tok

    def propose(self, streams, adapter_ids, k):
        return [np.full(min(k, self.k), self.tok, np.int32) for _ in streams]


# ---------------------------------------------------------------------------
# drafter units (mirror test_ngram_drafter_proposes_continuation_of_most_
# recent_hit, test_ngram_vectorized_matches_reference,
# test_ngram_empty_and_degenerate)
# ---------------------------------------------------------------------------


def test_ngram_proposes_the_continuation_of_the_most_recent_hit():
    d = NGramDrafter(max_n=3, min_n=1)
    (out,) = d.propose([np.array([5, 6, 7, 8, 5, 6, 7])], [0], 3)
    assert out.tolist() == [8, 5, 6]
    (out,) = d.propose([np.array([1, 2, 9, 1, 2, 8, 1, 2])], [0], 4)
    assert out.tolist() == [8, 1, 2]
    (out,) = d.propose([np.array([1, 2, 3, 4, 5])], [0], 4)
    assert out.size == 0
    for s in (np.array([7]), np.empty(0, np.int32)):
        (out,) = d.propose([s], [0], 4)
        assert out.size == 0
    (out,) = d.propose([np.array([1, 2, 1, 2, 1], np.int32)], [0], 3)
    assert out.tolist() == [2, 1]
    assert d.propose([], [], 4) == []


@pytest.mark.parametrize("max_n,min_n", [(3, 1), (4, 2)])
def test_ngram_propose_equals_jax_and_propose_ref(max_n, min_n):
    rng = np.random.default_rng(max_n)
    port = NGramDrafter(max_n, min_n)
    ref = jspec.NGramDrafter(max_n, min_n)
    for _ in range(200):
        B = int(rng.integers(1, 6))
        streams = [rng.integers(0, int(rng.integers(1, 6)),
                                size=int(rng.integers(0, 40)))
                   .astype(np.int32) for _ in range(B)]
        k = int(rng.integers(0, 6))
        got = port.propose(streams, [0] * B, k)
        for want in (ref.propose(streams, [0] * B, k),
                     port.propose_ref(streams, [0] * B, k)):
            assert len(got) == len(want) == B
            for g, w in zip(got, want):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------


def test_verify_accept_at_temperature_0_equals_jax():
    """Rows whose drafts follow the argmax chain for ``a`` steps and then
    go wrong, rows with every draft right, and rows without drafts."""
    rng = np.random.default_rng(0)
    B, C, V = 8, 5, 16
    logits = rng.standard_normal((B, C, V)).astype(np.float32)
    greedy = logits.argmax(-1)
    tokens = rng.integers(0, V, (B, C)).astype(np.int32)
    dlens = np.array([4, 4, 3, 2, 1, 0, 4, 2], np.int32)
    right = [4, 1, 3, 0, 1, 0, 2, 2]              # leading correct drafts
    for b in range(B):
        for j in range(1, dlens[b] + 1):
            ok = j <= right[b]
            tokens[b, j] = (greedy[b, j - 1] if ok
                            else (greedy[b, j - 1] + 1) % V)
        tokens[b, dlens[b] + 1:] = 0
    temps = np.zeros(B, np.float32)
    je, jn = jspec.verify_accept(jnp.asarray(logits), jnp.asarray(tokens),
                                 jnp.asarray(dlens), jnp.asarray(temps),
                                 jax.random.PRNGKey(3))
    pe, pn = verify_accept(torch.from_numpy(logits),
                           torch.from_numpy(tokens),
                           torch.from_numpy(dlens), None,
                           any_sampled=False)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    assert pn.tolist() == [min(r, d) + 1 for r, d in zip(right, dlens)]


def test_verify_accept_at_temperature_1_draws_from_the_target():
    """One draft ``d`` per row at temperature 1 over N = 20000 rows of the
    same logits: the acceptance frequency estimates ``p_0(d)`` (bound: 5
    standard deviations of a binomial mean, 0.016 here); a rejected row's
    correction is drawn from ``p_0`` without ``d`` renormalized, an
    accepted row's bonus token from ``p_1`` (bound: 5 standard deviations
    of each category's frequency, at most 0.021 and 0.025)."""
    N, V, d = 20000, 4, 1
    base = torch.tensor([[0.5, 0.3, -0.4, 1.0], [1.2, -0.2, 0.1, 0.4]])
    logits = base[None].expand(N, 2, V).contiguous()
    tokens = torch.tensor([[2, d]], dtype=torch.int32).expand(N, 2)
    dl = torch.ones(N, dtype=torch.int32)
    temps = torch.ones(N)
    gen = torch.Generator().manual_seed(0)
    emit, n_emit = verify_accept(logits, tokens.contiguous(), dl, temps, gen,
                                 any_sampled=True)
    p0, p1 = torch.softmax(base[0], -1), torch.softmax(base[1], -1)
    acc = n_emit == 2
    pd = float(p0[d])
    assert abs(float(acc.float().mean()) - pd) < 5 * np.sqrt(
        pd * (1 - pd) / N)
    assert torch.all(emit[acc, 0] == d)
    resid = p0.clone()
    resid[d] = 0
    resid /= resid.sum()
    for rows, col, want in ((~acc, 0, resid), (acc, 1, p1)):
        got = emit[rows, col]
        freq = torch.bincount(got.long(), minlength=V).float() / len(got)
        bound = 5 * np.sqrt(0.25 / len(got))
        assert float((freq - want).abs().max()) < bound, (freq, want)


def test_sample_tokens_forbid_equals_jax_at_temperature_0():
    """The residual draw's mask: a forbidden id (the argmax in some rows,
    -1 = none in others) gives JAX's greedy token."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 11)).astype(np.float32)
    forbid = np.where(np.arange(6) % 2 == 0, logits.argmax(-1), -1)
    want = jsampling.sample_tokens(jnp.asarray(logits), jnp.zeros(6),
                                   jax.random.PRNGKey(0),
                                   forbid=jnp.asarray(forbid))
    got = sample_tokens(torch.from_numpy(logits), None, any_sampled=False,
                        forbid=torch.from_numpy(forbid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[::2] != logits.argmax(-1)[::2]).all()


def test_forward_keeps_j_positions_per_row(llama):
    """A (B, J) ``last_idx`` (the verify step's) gives the full forward's
    logits at those positions."""
    toks = torch.from_numpy(np.stack(PROMPTS[:3]))
    idx = torch.tensor([[0, 1, 2], [7, 7, 7], [3, 5, 6]])
    full = tfm.forward(llama.cfg, llama.params, {"tokens": toks})[0]
    some = tfm.forward(llama.cfg, llama.params, {"tokens": toks},
                       last_idx=idx)[0]
    assert some.shape == (3, 3, llama.cfg.vocab_size)
    torch.testing.assert_close(
        some, full[torch.arange(3)[:, None], idx], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# spec == replay-oracle greedy equivalence (llama)
# ---------------------------------------------------------------------------


def test_spec_ngram_matches_replay_oracle_with_mid_verify_rejections(llama):
    """Mirrors test_spec_ngram_matches_replay_oracle and
    test_mid_verify_rejection_rolls_back: the n-gram drafter's tokens equal
    the oracle's, some drafts are accepted and some rejected, and every
    rejected one is counted as rolled back."""
    eng, st = _serve(llama, PROMPTS, N_NEW, max_slots=3, max_len=MAX_LEN,
                     page_size=8, prefill_chunk=8,
                     spec=SpecConfig(k=4, drafter="ngram"))
    assert st.spec.enabled and st.spec.steps >= 1
    assert st.spec.drafted_tokens >= 1 and st.spec.accepted_tokens >= 1
    assert st.spec.rolled_back_tokens >= 1
    assert 0.0 < st.spec.accept_rate < 1.0
    assert st.spec.recurrent_rollbacks == 0        # cursor-only rollback
    assert st.spec.draft_compiles is None
    # the verify chunks widened the chunk ladder to k + 1
    assert max(c for c, _ in st.compile.step_signatures) <= 8
    d = st.as_dict()
    assert d["spec_drafter"] == "ngram" and d["spec_k"] == 4
    assert "draft_compiles" not in d


def test_spec_selfdraft_matches_replay_oracle(llama):
    """Mirrors test_spec_selfdraft_matches_replay_oracle: the int4
    self-drafter's signatures are (context bucket, k), not one a tick."""
    eng, st = _serve(llama, PROMPTS, N_NEW, max_slots=3, max_len=MAX_LEN,
                     page_size=8, prefill_chunk=8,
                     spec=SpecConfig(k=3, drafter="selfdraft", draft_bits=4,
                                     draft_ctx=32))
    assert st.spec.drafted_tokens >= 1 and st.spec.accepted_tokens >= 1
    assert st.spec.draft_compiles <= 4
    assert all(k == 3 for _, k in st.spec.draft_signatures)
    assert eng.drafter.calls > st.spec.draft_compiles
    # the drafter's crossbar weights are int4 codes
    qt = eng.drafter.qparams["layers"][0]["attn"]["wq"]
    assert qt.bits == 4


def test_selfdraft_proposals_equal_jax(llama):
    """The quantized self-drafter's drafts (int4 codes of the same f32
    weights, its prefill and k - 1 greedy decode forwards) equal the JAX
    package's drafter's on the same streams and adapters, over one
    (context bucket, k) signature."""
    spec = SpecConfig(k=3, drafter="selfdraft", draft_ctx=16)
    jspec_cfg = jspec.SpecConfig(k=3, drafter="selfdraft", draft_ctx=16)
    jads = jlora.stack_adapters([llama.jads[0], llama.jads[1]])
    want_dr = jspec.QuantSelfDrafter(llama.jcfg, llama.jparams, jads,
                                     jspec_cfg, jtfm.ExecConfig(), 3)
    port_dr = QuantSelfDrafter(llama.cfg, llama.params,
                               lora.stack_adapters(llama.adapters), spec,
                               tfm.ExecConfig(), 3)
    rng = np.random.default_rng(4)
    for lens in ((12, 20, 9), (16, 30)):
        streams = [rng.integers(0, llama.cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        aids = [i % 2 for i in range(len(lens))]
        got = port_dr.propose(streams, aids, 3)
        want = want_dr.propose(streams, aids, 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert port_dr.stats() == want_dr.stats() == {
        "draft_signatures": [(16, 3)], "draft_compiles": 1}


def test_spec_matches_replay_oracle_under_preemption(llama):
    """A pool of 7 pages of 4 tokens cannot hold two growing requests: the
    youngest is preempted while speculating and resumes by recompute; no
    page leaks."""
    eng, st = _serve(llama, PROMPTS, N_NEW, max_slots=3, max_len=32,
                     page_size=4, num_pages=7, prefill_chunk=4,
                     spec=SpecConfig(k=4, drafter="ngram"))
    assert st.scheduler.preemptions >= 1


def test_spec_composes_with_prefix_sharing(llama):
    """Shared-prefix traffic under speculation: copy-on-write forks run
    before the speculative writes, so a rollback never corrupts a
    co-holder."""
    eng, st = _serve(llama, PROMPTS, N_NEW, max_slots=2, max_len=MAX_LEN,
                     page_size=4, prefill_chunk=4,
                     spec=SpecConfig(k=4, drafter="ngram"))
    assert st.prefix_cache.hit_tokens >= 1
    assert st.spec.drafted_tokens >= 1


def test_spec_temperature_sampling_is_seeded(llama):
    outs = []
    for _ in range(2):
        eng = make_engine(llama.cfg, llama.params, llama.adapters,
                          device="cpu", max_slots=2, max_len=MAX_LEN,
                          page_size=8, seed=42,
                          spec=SpecConfig(k=3, drafter="ngram"))
        for i, p in enumerate(PROMPTS[:3]):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=N_NEW,
                               temperature=1.0))
        outs.append({u: r.generated for u, r in eng.run_until_done().items()})
    assert outs[0] == outs[1]


def test_make_engine_spec_names_and_refusals(llama):
    """A drafter name gives the defaults; the dense oracle refuses spec
    (JAX's ValueError); the self-drafter refuses a quantized base, on which
    the JAX package's fails too."""
    eng = make_engine(llama.cfg, llama.params, llama.adapters, device="cpu",
                      max_slots=2, max_len=32, page_size=8, spec="ngram")
    assert eng.stats().spec.enabled
    assert eng.spec.drafter == "ngram" and eng.spec.k == 4
    assert eng.chunk_buckets[-1] == 32
    with pytest.raises(ValueError, match="paged"):
        make_engine(llama.cfg, llama.params, llama.adapters, mode="dense",
                    device="cpu", max_batch=2, max_len=32, spec=SpecConfig())
    with pytest.raises(ValueError, match="unknown drafter"):
        make_engine(llama.cfg, llama.params, llama.adapters, device="cpu",
                    spec=SpecConfig(drafter="oracle"))
    m8f8 = _to_torch(jquant.quantize_params(llama.jparams,
                                            JaxQuantConfig(8, 8), min_size=1))
    with pytest.raises(ValueError, match="QuantizedTensor"):
        make_engine(llama.cfg, m8f8, llama.adapters, device="cpu",
                    spec="selfdraft")
    assert not make_engine(llama.cfg, llama.params, device="cpu",
                           max_len=32).stats().spec.enabled


# ---------------------------------------------------------------------------
# rwkv6-7b: recurrent rollback (mirror test_recurrent_rollback_and_slot_
# recycling_match_replay_oracle, test_spec_recurrent_under_preemption_...)
# ---------------------------------------------------------------------------


def test_rwkv_recurrent_rollback_and_slot_recycling_match_oracle(rwkv):
    """An always-wrong drafter forces a recurrent rollback on nearly every
    decode tick, and a second wave reuses the recycled slots (the reset
    zeroes restored snapshots): every request equals the oracle."""
    eng = make_engine(rwkv.cfg, rwkv.params, rwkv.adapters, device="cpu",
                      max_slots=2, max_len=48, page_size=8, prefill_chunk=8,
                      spec=SpecConfig(k=3, drafter="ngram"))
    eng.drafter = _WrongDrafter(k=3)
    prompts = PROMPTS[:4]
    for wave in range(2):
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=100 * wave + i, prompt=p,
                               max_new_tokens=N_NEW, adapter_id=i % 2))
        done = eng.run_until_done()
        for i, p in enumerate(prompts):
            assert done[100 * wave + i].generated == rwkv.expected(
                p, i % 2, N_NEW, 48), (wave, i)
    st = eng.stats()
    assert st.spec.recurrent_rollbacks >= 1
    assert st.scheduler.recurrent_rollbacks == st.spec.recurrent_rollbacks
    assert not st.prefix_cache.enabled
    assert eng.sched.alloc.used_pages == 0


def test_rwkv_spec_ngram_under_preemption_matches_oracle(rwkv):
    """A pool of 6 pages of 4 tokens: two requests are admitted at 3 pages
    each and the younger is preempted when the older grows to a fourth;
    recurrent rollbacks interleave with the preemption."""
    eng, st = _serve(rwkv, PROMPTS[:4], N_NEW, max_slots=3, max_len=32,
                     page_size=4, num_pages=6, prefill_chunk=4,
                     spec=SpecConfig(k=4, drafter="ngram"))
    assert st.scheduler.preemptions >= 1
    if st.spec.rolled_back_tokens:
        assert st.spec.recurrent_rollbacks >= 1


def test_slot_state_arena_snapshot_restore_reset_equal_jax(rwkv):
    """restore() selects post-chunk or snapshot state per slot, reset()
    zeroes the tracked rows: the port, in place, against the JAX arena on
    the same values; a full-attention model tracks nothing."""
    lay = kvcache.PagedLayout(page_size=4, num_pages=4, max_slots=3)
    cache = kvcache.init_paged_cache(rwkv.cfg, lay, 16, device="cpu")
    rng = np.random.default_rng(0)
    for entry in cache["layers"]:
        for leaf in entry.values():
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(leaf.shape).astype(np.float32)))
    jarena = jkvcache.SlotStateArena(rwkv.jcfg)
    arena = kvcache.SlotStateArena(rwkv.cfg)
    assert arena.leaves == jarena.leaves and arena.tracked
    jcache = {"layers": tuple({n: jnp.asarray(v.numpy().copy())
                                  for n, v in e.items()}
                              for e in cache["layers"])}
    jck = jarena.snapshot(jcache)
    ck = arena.snapshot(cache)
    assert arena.snapshot(cache, ck) is ck
    for entry in cache["layers"]:
        for leaf in entry.values():
            leaf.add_(100.0)
    jmut = jax.tree.map(lambda x: x + 100.0, jcache)
    keep = np.array([True, False, True])
    jout = jarena.restore(jmut, jck, jnp.asarray(keep))
    assert arena.restore(cache, ck, torch.from_numpy(keep)) is cache
    jout = jarena.reset(jout, [2])
    arena.reset(cache, [2])
    for pe, je in zip(cache["layers"], jout["layers"]):
        for n, leaf in pe.items():
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(je[n]))
    llama = kvcache.SlotStateArena(reduce_config(get_config("llama3.2-1b")))
    assert not llama.tracked and llama.snapshot(cache) is None
    assert llama.restore(cache, None, torch.from_numpy(keep)) is cache


# ---------------------------------------------------------------------------
# scheduler-level rollback accounting (mirror test_rollback_* and
# test_refcounts_drain_to_zero_with_rollbacks)
# ---------------------------------------------------------------------------


def _req(tokens, adapter=0):
    return SimpleNamespace(prompt=np.asarray(tokens, np.int32),
                           adapter_id=adapter)


def test_rollback_frees_only_wholly_rejected_pages():
    lay = kvcache.PagedLayout(page_size=4, num_pages=8, max_slots=2)
    sched = PageScheduler(lay, max_len=32)
    slot = sched.admit(_req(np.arange(7)), 7, tick=0)   # 7+1 tokens, 2 pages
    assert sched.ensure(slot, 12, protect=[slot])       # grow to 3 pages
    sched.lens[slot] = 12
    freed = sched.rollback(slot, 6)                     # keep 2 pages
    assert freed == 1 and sched.rolled_back_pages == 1
    assert int(sched.lens[slot]) == 6
    assert sched.tables[slot, 2] == -1 and len(sched.slots[slot].pages) == 2
    assert sched.rollback(slot, 5) == 0
    assert sched.occupancy()["rolled_back_pages"] == 1
    sched.release(slot)
    assert sched.alloc.used_pages == 0
    sched.alloc.check_invariants()


def test_rollback_spares_pages_held_by_a_co_holder():
    lay = kvcache.PagedLayout(page_size=4, num_pages=8, max_slots=2)
    sched = PageScheduler(lay, max_len=32)
    slot = sched.admit(_req(np.arange(7)), 7, tick=0)
    tail = sched.slots[slot].pages[-1]
    sched.alloc.incref(tail)                 # a simulated co-holder
    assert sched.rollback(slot, 4) == 0      # decref'd, not freed
    assert sched.alloc.refcount(tail) == 1
    assert sched.alloc.used_pages == 2
    assert sched.alloc.decref(tail) is True
    sched.release(slot)
    assert sched.alloc.used_pages == 0
    sched.alloc.check_invariants()


@pytest.mark.parametrize("seed", range(6))
def test_refcounts_drain_to_zero_with_rollbacks(seed):
    """Random admit / grow / rollback / recurrent rollback / finish /
    preempt traffic with prefix sharing: after the drain every page is
    back on the free list (the JAX test's hypothesis draws, as seeds)."""
    rng = np.random.default_rng(seed)
    P = 4
    lay = kvcache.PagedLayout(page_size=P, num_pages=16, max_slots=4)
    sched = PageScheduler(lay, max_len=24)
    idx = PrefixIndex(sched.alloc, P)
    sched.reclaim = idx.evict
    n_rec = 0
    for tick in range(1, 81):
        op = rng.choice(["admit", "grow", "rollback", "spec_rollback",
                         "finish", "preempt"])
        if op == "admit" and sched.free_slot() is not None:
            plen = int(rng.integers(2, 12))
            prompt = rng.integers(0, 3, plen).astype(np.int32)
            shared = idx.lookup(0, prompt[:plen - 1])
            sched.admit(_req(prompt), plen, tick, shared=shared)
        elif op == "grow" and sched.active():
            s = int(rng.choice(sched.active()))
            new_len = int(sched.lens[s]) + int(rng.integers(1, 6))
            if new_len < 24 and sched.ensure(s, new_len, protect=[s]):
                sched.lens[s] = new_len
        elif op == "rollback" and sched.active():
            s = int(rng.choice(sched.active()))
            if int(sched.lens[s]) > 1:
                sched.rollback(s, int(rng.integers(1, sched.lens[s] + 1)))
        elif op == "spec_rollback" and sched.active():
            s = int(rng.choice(sched.active()))
            L = int(sched.lens[s])
            chunk = int(rng.integers(1, 5))
            if (L > 0 and L + chunk < 24
                    and sched.ensure(s, L + chunk, protect=[s])):
                sched.lens[s] = L + chunk
                sched.rollback(s, L, recurrent=True)
                n_rec += 1
        elif op == "finish" and sched.active():
            s = int(rng.choice(sched.active()))
            stt = sched.slots[s]
            toks = stt.req.prompt
            if int(sched.lens[s]) >= len(toks):
                idx.register(0, toks[:(len(toks) // P) * P], stt.pages, tick)
                if len(toks) % P:
                    idx.register_tail(0, toks, stt.pages[len(toks) // P],
                                      tick)
                sched.release(s)
        elif op == "preempt" and sched.active():
            sched.preempt(int(rng.choice(sched.active())))
        sched.take_forks()
        sched.drain_evicted()
    for s in sched.active():
        sched.release(s)
    idx.clear()
    assert sched.recurrent_rollbacks == n_rec
    assert sched.alloc.free_pages == lay.num_pages
    assert sched.alloc.shared_pages == 0
    sched.alloc.check_invariants()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", ["ngram", "selfdraft"])
def test_launch_serve_spec_decode_on_the_cpu(draft, capsys):
    done = launch_serve.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                              "cpu", "--spec-decode", "--draft", draft,
                              "--spec-k", "3", "--requests", "3",
                              "--max-new", "4", "--prompt-families", "1"])
    assert sorted(done) == [0, 1, 2]
    assert all(c.n_tokens == 4 for c in done.values())
    out = capsys.readouterr().out
    assert "'spec_enabled': True" in out and f"'spec_drafter': '{draft}'" in out
    with pytest.raises(SystemExit, match="--engine paged"):
        launch_serve.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                           "cpu", "--engine", "dense", "--spec-decode"])
