"""The port's dense oracle engine (``DenseServeEngine``, CPU, plain kernel
versions) against the JAX package's ``DenseServeEngine`` and the
engine-independent replay oracle ``tests/oracle.replay_greedy``, token for
token, on reduced llama3.2-1b, rwkv6-7b and paper-gpt2-medium, each with a
plain f32 base and an M8F8 crossbar base, two adapters, mixed prompt
lengths (one pads to a larger bucket), slot reuse, an eos stop and a
length cap. Its stats (prefill buckets, KV bytes) and ``cache_bytes`` of
dense and paged caches equal JAX's. Weights are JAX's, carried across by
``repro_torch.bridge``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import replay_greedy

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.models import kvcache as jkvcache
from repro.models import transformer as jtfm
from repro.serve.api import Request as JRequest
from repro.serve.engine import DenseServeEngine as JDenseServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import kvcache
from repro_torch.serve.api import Completion, Request, make_engine
from repro_torch.serve.engine import DenseServeEngine

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(3)
ARCHS = ("llama3.2-1b", "rwkv6-7b", "paper-gpt2-medium")
MAX_LEN, MAX_BATCH = 32, 3
# prompt lengths in two buckets, 8 and 16 (5 and 11 pad to the bucket
# above them; the eos and length-cap prompts below take the same two)
PLENS = (5, 7, 11, 16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    jcfg = jreduce_config(jget_config(arch))
    params = jtfm.init_params(jcfg, KEY)
    ad0 = jlora.init_lora_params(jcfg, jax.random.fold_in(KEY, 1))
    # B != 0, so that each adapter changes the tokens
    ad1 = jax.tree.map(lambda x: x + 0.2, ad0)
    return jcfg, params, [ad0, ad1]


def _models(arch, base):
    jcfg, params, ads = _jax_model(arch)
    if base == "M8F8":
        params = jquant.quantize_params(params, JQuantConfig(8, 8),
                                        min_size=1)
    return jcfg, reduce_config(get_config(arch)), params, ads


def _serve(eng, request_cls, reqs):
    for uid, p, n, a, eos in reqs:
        eng.submit(request_cls(uid=uid, prompt=p, max_new_tokens=n,
                               adapter_id=a, eos_id=eos))
    return eng.drain()


@pytest.mark.parametrize("base", ["dense", "M8F8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_matches_jax_engine_and_replay_oracle(arch, base):
    """Mixed prompt lengths over 3 slots (so slots are reused), then a
    request that stops at its eos (its third greedy token, absent from the
    first two: both engines decode at least once after the prefill) and
    one cut by the length cap. Every request against the JAX engine; on
    the f32 base, the eos request (its 6 tokens pad to the 8 bucket) also
    against ``replay_greedy`` (an eager JAX forward per token, so only
    that one)."""
    jcfg, cfg, params, ads = _models(arch, base)
    tparams = bridge.to_torch(_np(params), "cpu")
    tads = [bridge.to_torch(_np(a), "cpu") for a in ads]

    def port_engine():
        return make_engine(cfg, tparams, tads, mode="dense", device="cpu",
                           max_batch=MAX_BATCH, max_len=MAX_LEN,
                           record_logits=True)

    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 4,
             i % 2, None) for i, n in enumerate(PLENS)]
    # the eos: the port's greedy tokens pick it, both engines then stop
    while True:
        p = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
        free = _serve(port_engine(), Request, [(0, p, 3, 1, None)])[0].tokens
        if free[2] not in free[:2]:
            break
    reqs.append((len(reqs), p, 8, 1, free[2]))
    cap = rng.integers(0, cfg.vocab_size, 15).astype(np.int32)
    reqs.append((len(reqs), cap, 40, 0, None))

    eng = port_engine()
    assert isinstance(eng, DenseServeEngine)
    jeng = JDenseServeEngine(jcfg, params, ads, max_batch=MAX_BATCH,
                             max_len=MAX_LEN)
    done, jdone = _serve(eng, Request, reqs), _serve(jeng, JRequest, reqs)
    assert sorted(done) == sorted(jdone) == [r[0] for r in reqs]
    for uid, *_ in reqs:
        assert isinstance(done[uid], Completion)
        assert list(done[uid].tokens) == list(jdone[uid].tokens), uid
        assert done[uid].finish_reason == jdone[uid].finish_reason
        rows = torch.stack(eng.sampled_logits[uid])
        assert rows.argmax(-1).tolist() == list(done[uid].tokens)
    assert done[4].tokens == free and done[4].finish_reason == "eos"
    assert len(done[5].tokens) == MAX_LEN - len(cap)       # length cap
    if base == "dense":
        uid, p, n, a, eos = reqs[4]
        assert list(done[uid].tokens) == replay_greedy(
            jcfg, params, ads, p, n, adapter_id=a, max_len=MAX_LEN,
            eos_id=eos)

    st, jst = eng.stats(), jeng.stats()
    assert st.engine == jst.engine == "dense"
    assert st.compile.prefill_signatures == jst.compile.prefill_signatures \
        == (8, 16)
    assert st.compile.prefill_compiles == jst.compile.prefill_compiles == 2
    assert st.kv_bytes == jst.kv_bytes
    assert (st.ticks, st.decode_tokens, st.prefill_tokens) == (
        jst.ticks, jst.decode_tokens, jst.prefill_tokens)
    keys = ("engine", "prefill_signatures", "prefill_compiles", "kv_bytes")
    d, jd = st.as_dict(), jst.as_dict()
    assert {k: d[k] for k in keys} == {k: jd[k] for k in keys}
    assert st.compile.compiled_steps == 0          # the CPU runs eagerly
    assert st.scheduler is None and st.prefix_cache is None


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes_equals_jax(arch):
    """Bytes of every leaf of a dense and of a paged cache, as JAX counts
    them for the same config and layout."""
    jcfg = jreduce_config(jget_config(arch))
    cfg = reduce_config(get_config(arch))
    assert kvcache.cache_bytes(kvcache.init_cache(
        cfg, 3, 40, device="cpu")) == jkvcache.cache_bytes(
        jkvcache.init_cache(jcfg, 3, 40, kv_dtype=jnp.float32))
    layout = kvcache.PagedLayout(page_size=4, num_pages=11, max_slots=3)
    jlayout = jkvcache.PagedLayout(page_size=4, num_pages=11, max_slots=3)
    assert kvcache.cache_bytes(kvcache.init_paged_cache(
        cfg, layout, 40, device="cpu")) == jkvcache.cache_bytes(
        jkvcache.init_paged_cache(jcfg, jlayout, 40, kv_dtype=jnp.float32))


def test_dense_engine_runs_from_the_launcher(capsys):
    done = launch_serve.main(["--arch", "paper-gpt2-medium", "--smoke",
                              "--device", "cpu", "--engine", "dense",
                              "--requests", "3", "--max-new", "3"])
    assert sorted(done) == [0, 1, 2]
    assert all(c.n_tokens == 3 for c in done.values())
    out = capsys.readouterr().out
    assert "[dense on cpu]" in out and "'kv_bytes'" in out
    for flags, msg in ((["--spec-decode"], "--spec-decode requires"),
                       (["--tp", "2"], "--tp requires"),
                       (["--moe-dispatch", "capacity"], "dropless")):
        with pytest.raises(SystemExit, match=msg):
            launch_serve.main(["--arch", "llama3.2-1b", "--smoke",
                               "--device", "cpu", "--engine", "dense",
                               *flags])


def test_idle_rows_restart_and_a_full_dense_cache_raises():
    """One slot stays idle while two requests in turn decode, through the
    other, for more ticks than the arena holds: the engine restarts the
    idle row before it passes the arena's end (it serves without error,
    and the second request's tokens equal a fresh engine's). An eager
    decode into a full dense cache raises."""
    from repro_torch.models import transformer as tfm

    cfg = reduce_config(get_config("llama3.2-1b"))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    p0, p1 = (np.arange(3, dtype=np.int32) + k for k in (1, 5))

    def engine():
        return make_engine(cfg, params, mode="dense", device="cpu",
                           max_batch=2, max_len=16)

    eng = engine()
    first = _serve(eng, Request, [(0, p0, 12, 0, None)])
    second = _serve(eng, Request, [(1, p1, 12, 0, None)])
    assert eng.stats().ticks > 16                 # the idle row's decodes
    assert first[0].n_tokens == second[1].n_tokens == 12
    assert second[1].tokens == _serve(engine(), Request,
                                      [(1, p1, 12, 0, None)])[1].tokens

    cache = kvcache.init_cache(cfg, 1, 8, device="cpu")
    for entry in cache["layers"]:
        entry["len"].fill_(8)
    with pytest.raises(ValueError, match="is full"):
        tfm.forward(cfg, params, {"tokens": torch.tensor([[1]])},
                    cache=cache, positions=torch.tensor([[8]]),
                    mode="decode")
