"""Mixture-of-experts serving in the port (CPU, plain kernel versions)
against ``tests/oracle.replay_greedy`` (the JAX package's token-at-a-time
replay under dropless routing), at reduced llama4-scout (M8F8 base: the
grouped crossbar's plain version; qk-norm, a shared expert, top-1) and
reduced mixtral (f32 base; top-2, a sliding window of 8), with the JAX
weights carried across by ``repro_torch.bridge``:

  * the paged engine at two chunk widths, under preemption (a small
    pool, the prefix cache off), and with n-gram speculation
    (llama4-scout), and the dense engine: greedy tokens equal the
    oracle's, no drop, ``MoEStats`` as JAX reports them;
  * the capacity baseline (``moe_dispatch="capacity"``) really drops on
    the MoE throughput workload's traffic (prompts of 6-48 tokens in
    chunks of 8), while dropless does not; the dense engine forces
    dropless; a bad mode is refused.

Every prompt has the same length (12), so the oracle's jitted forward
compiles once per model, and each oracle is computed once.
"""
import functools
from types import SimpleNamespace

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
from repro_torch.models import transformer as tfm
from repro_torch.serve.api import Request, make_engine
from repro_torch.serve.spec import SpecConfig

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(4)
N_NEW = 5
PROMPT_LEN = 12
PROMPTS = [np.random.default_rng(10 + s).integers(0, 257, PROMPT_LEN)
           .astype(np.int32) for s in range(3)]
ARCHS = ("llama4-scout-17b-a16e", "mixtral-8x22b")


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


_STATIC = ("mode", "prefill_cache_len", "exec_cfg")
_FORWARD = jtfm.forward


@functools.lru_cache(maxsize=None)
def _forward_of(cfg, static):
    return jax.jit(lambda params, inputs, **kw: _FORWARD(
        cfg, params, inputs, **dict(static), **kw))


def _jit_forward(cfg, params, inputs, **kw):
    """``jtfm.forward`` jitted per (cfg, static keywords)."""
    static = tuple((k, kw.pop(k)) for k in _STATIC if k in kw)
    return _forward_of(cfg, static)(params, inputs, **kw)


def _model(arch):
    jcfg = jax_reduce_config(jax_get_config(arch))
    params = jax.jit(functools.partial(jtfm.init_params, jcfg))(KEY)
    if arch.startswith("llama4"):
        params = jquant.quantize_params(params, JaxQuantConfig(8, 8),
                                        min_size=1)
    ad0 = jax.jit(functools.partial(jlora.init_lora_params, jcfg))(
        jax.random.fold_in(KEY, 1))
    ad1 = jax.tree.map(lambda x: x + 0.2, ad0)
    memo = {}

    def expected(i, adapter_id):
        if (i, adapter_id) not in memo:
            memo[(i, adapter_id)] = replay_greedy(
                jcfg, params, [ad0, ad1], PROMPTS[i], N_NEW,
                adapter_id=adapter_id, max_len=48)
        return memo[(i, adapter_id)]

    return SimpleNamespace(cfg=reduce_config(get_config(arch)),
                           params=_to_torch(params),
                           adapters=[_to_torch(ad0), _to_torch(ad1)],
                           expected=expected)


@pytest.fixture(scope="module")
def models():
    jtfm.forward = _jit_forward         # the oracle's forward, jitted
    try:
        yield {arch: _model(arch) for arch in ARCHS}
    finally:
        jtfm.forward = _FORWARD


def _serve(m, mode="paged", **kw):
    eng = make_engine(m.cfg, m.params, m.adapters, mode=mode, device="cpu",
                      max_len=48, **kw)
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=N_NEW,
                           adapter_id=i % 2))
    done = eng.run_until_done()
    for i in range(len(PROMPTS)):
        assert done[i].generated == m.expected(i, i % 2), i
    st = eng.stats()
    assert st.moe.enabled and st.moe.dispatch == "dropless"
    assert st.moe.dropped_tokens == 0
    assert st.as_dict()["moe_dropped_tokens"] == 0
    return eng, st


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_matches_oracle(models, arch, chunk):
    _serve(models[arch], max_slots=3, page_size=4, prefill_chunk=chunk)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_matches_oracle_under_preemption(models, arch):
    """Pages of 3 in a pool of 10, the prefix cache off: the younger
    request is preempted and recomputed in other chunks."""
    _, st = _serve(models[arch], max_slots=2, page_size=3, num_pages=10,
                   prefill_chunk=5, enable_prefix_cache=False)
    assert st.scheduler.preemptions >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_matches_oracle(models, arch):
    _serve(models[arch], mode="dense", max_batch=3)


def test_spec_ngram_matches_oracle(models):
    _, st = _serve(models["llama4-scout-17b-a16e"], max_slots=3,
                   page_size=8, prefill_chunk=8,
                   spec=SpecConfig(k=4, drafter="ngram"))
    assert st.spec.enabled
    assert st.spec.rolled_back_tokens == (st.spec.drafted_tokens
                                          - st.spec.accepted_tokens)


def test_capacity_baseline_really_drops():
    """The MoE throughput workload's traffic (reduced llama4-scout, prompts
    of 6-48 tokens, chunks of 8: C = ceil(8 * 1.25 / 4) = 3 rows a slot):
    the capacity baseline drops and reports it, dropless does not."""
    cfg = reduce_config(get_config("llama4-scout-17b-a16e"))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(6, 48)))
               .astype(np.int32) for _ in range(6)]
    drops = {}
    for dispatch in ("capacity", "dropless"):
        eng = make_engine(cfg, params, device="cpu", max_slots=8,
                          max_len=128, page_size=8, prefill_chunk=8,
                          enable_prefix_cache=False, moe_dispatch=dispatch)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=3))
        eng.run_until_done()
        st = eng.stats()
        assert st.moe.dispatch == dispatch
        drops[dispatch] = st.moe.dropped_tokens
    assert drops["capacity"] > 0 and drops["dropless"] == 0


def test_dense_engine_forces_dropless_and_bad_modes_are_refused():
    cfg = reduce_config(get_config("llama4-scout-17b-a16e"))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    eng = make_engine(cfg, params, mode="dense", device="cpu", max_batch=2,
                      max_len=32,
                      exec_cfg=tfm.ExecConfig(moe_dispatch="capacity"))
    assert eng.ec.moe_dispatch == "dropless"
    with pytest.raises(ValueError, match="moe_dispatch"):
        make_engine(cfg, params, device="cpu", moe_dispatch="bogus")
