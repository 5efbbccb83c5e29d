"""The port's PagedServeEngine (CPU, plain kernel versions) against the JAX
package's engine-independent replay oracle ``tests/oracle.replay_greedy``,
token for token: mixed prompt lengths and adapters, a shared-prefix wave
with copy-on-write divergence in the middle of a page, and forced
preemption in a tiny pool. Page refcounts drain to zero afterwards."""
import jax
import numpy as np
import pytest
import torch
from oracle import replay_greedy

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_config
from repro_torch.serve.api import Completion, Engine, Request, make_engine
from repro_torch.serve.engine import PagedServeEngine

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False   # f32 reference products
KEY = jax.random.PRNGKey(0)
N_NEW = 3


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce_config(jax_get_config("llama3.2-1b"))
    cfg = reduce_config(get_config("llama3.2-1b"))
    base = jquant.quantize_params(jtfm.init_params(jcfg, KEY),
                                  JaxQuantConfig(8, 8), min_size=1)
    ad0 = jlora.init_lora_params(jcfg, jax.random.fold_in(KEY, 1))
    ad1 = jax.tree.map(lambda x: x + 0.3, ad0)

    def to_torch(tree):
        return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")

    oracle = {}

    def expected(prompt, adapter_id, max_len, max_new=N_NEW, eos_id=None):
        key = (tuple(int(t) for t in prompt), adapter_id, max_len, max_new,
               eos_id)
        if key not in oracle:
            oracle[key] = replay_greedy(jcfg, base, [ad0, ad1], prompt,
                                        max_new, adapter_id=adapter_id,
                                        max_len=max_len, eos_id=eos_id)
        return oracle[key]

    return cfg, to_torch(base), [to_torch(ad0), to_torch(ad1)], expected


def _serve(setup, prompts, adapter_of, **engine_kw):
    cfg, params, adapters, expected = setup
    eng = make_engine(cfg, params, adapters, mode="paged", device="cpu",
                      record_logits=True, **engine_kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=N_NEW,
                           adapter_id=adapter_of(i)))
    done = eng.drain()
    assert sorted(done) == list(range(len(prompts)))
    for i, p in enumerate(prompts):
        assert isinstance(done[i], Completion)
        assert list(done[i].tokens) == expected(
            p, adapter_of(i), engine_kw["max_len"]), i
        # the recorded logits are the rows the greedy tokens came from
        rows = torch.stack(eng.sampled_logits[i])
        assert rows.argmax(-1).tolist() == list(done[i].tokens)
    return eng


def _family(rng, vocab, head_len, tails):
    head = rng.integers(0, vocab, head_len).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, t).astype(np.int32)])
            for t in tails]


def _drained(eng):
    eng.release_prefix_cache()
    assert eng.sched.alloc.used_pages == 0
    eng.sched.alloc.check_invariants()


def test_mixed_lengths_and_adapters_match_replay_oracle(setup):
    cfg = setup[0]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 11, 19, 6)]
    eng = _serve(setup, prompts, lambda i: i % 2, max_slots=3, max_len=48,
                 page_size=8, prefill_chunk=8)
    assert isinstance(eng, Engine) and isinstance(eng, PagedServeEngine)
    st = eng.stats()
    assert st.prefill_tokens == sum(len(p) for p in prompts)
    assert st.decode_tokens == len(prompts) * (N_NEW - 1)
    # every step shape is a (chunk bucket, table bucket) pair
    assert all(c in eng.chunk_buckets and nb in eng.block_buckets
               for c, nb in st.compile.step_signatures)
    _drained(eng)


def test_shared_prefix_diverging_mid_page_matches_replay_oracle(setup):
    """Four requests share a 21-token head (pages of 8: two full pages and
    five tokens into the third). The first prompt IS the head, so its
    finish donates the partial third page; later sharers map it and fork
    it copy-on-write at their first divergent token."""
    cfg = setup[0]
    prompts = _family(np.random.default_rng(3), cfg.vocab_size, 21,
                      [0, 3, 5, 7])
    eng = _serve(setup, prompts, lambda i: 0, max_slots=3, max_len=48,
                 page_size=8, num_pages=48, prefill_chunk=8)
    st = eng.stats()
    assert st.prefix_cache.hit_tokens > 0 and st.prefix_cache.hits >= 2
    assert st.scheduler.cow_forks >= 1
    _drained(eng)


def test_forced_preemption_matches_replay_oracle(setup):
    """A pool of 6 pages of 4 tokens cannot hold three growing requests:
    the youngest is preempted (a prefix sharer), resumes by recompute, and
    still matches."""
    cfg = setup[0]
    prompts = _family(np.random.default_rng(5), cfg.vocab_size, 6,
                      [5, 7, 9, 6])
    eng = _serve(setup, prompts, lambda i: 0, max_slots=3, max_len=32,
                 page_size=4, num_pages=6, prefill_chunk=4)
    st = eng.stats()
    assert st.scheduler.preemptions >= 1
    assert st.prefix_cache.hit_tokens > 0
    assert st.scheduler.reclaimed_pages <= st.scheduler.preemptions * \
        eng.sched.max_blocks
    _drained(eng)


def test_engine_rejects_what_it_cannot_serve(setup):
    cfg, params, adapters, _ = setup
    eng = make_engine(cfg, params, adapters, device="cpu", max_slots=2,
                      max_len=16, page_size=4, num_pages=3)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(uid=0, prompt=np.zeros(0, np.int32)))
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(Request(uid=1, prompt=np.ones(16, np.int32)))
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request(uid=2, prompt=np.ones(12, np.int32)))
    for kw in (dict(spec="ngram"), dict(prefix_cache_path="x.npz"),
               dict(moe_dispatch="capacity")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_engine(cfg, params, adapters, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        make_engine(cfg, params, adapters, mode="dense", device="cpu")


@pytest.mark.parametrize("case", ["eos", "length_cap", "prompt_of_max_len_1"])
def test_end_of_request_matches_replay_oracle(setup, case):
    """The three ways a request ends, each held against the replay oracle
    with the same stopping rules: an ``eos_id`` stop (the eos token is the
    third greedy token, so the request ends before ``max_new_tokens``); a
    request cut by the length cap (40 new tokens asked, ``max_len`` 16);
    a prompt of ``max_len - 1`` tokens (two tokens: the prefill's and one
    decode)."""
    cfg, params, adapters, expected = setup
    rng = np.random.default_rng(11)
    max_len, eos_id = 16, None
    if case == "eos":
        prompt, max_new = rng.integers(0, cfg.vocab_size, 5), 8
        free = expected(prompt, 1, max_len, max_new)
        eos_id = free[2]
    elif case == "length_cap":
        prompt, max_new = rng.integers(0, cfg.vocab_size, 5), 40
    else:
        prompt, max_new = rng.integers(0, cfg.vocab_size, max_len - 1), 5
    prompt = prompt.astype(np.int32)
    eng = make_engine(cfg, params, adapters, device="cpu", max_slots=2,
                      max_len=max_len, page_size=4, prefill_chunk=4)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=max_new,
                       adapter_id=1, eos_id=eos_id))
    done = eng.drain()[0]
    want = expected(prompt, 1, max_len, max_new, eos_id)
    assert list(done.tokens) == want
    if case == "eos":
        assert done.finish_reason == "eos" and want[-1] == eos_id
        assert len(want) < max_new
    else:
        assert done.finish_reason == "length" and len(want) < max_new
    if case == "prompt_of_max_len_1":
        assert len(want) == 2
    _drained(eng)
