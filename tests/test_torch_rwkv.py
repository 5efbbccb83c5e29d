"""Port parity for RWKV6 (rwkv6-7b): the wkv recurrence, the block, the
model and the paged engine of the port (plain kernel versions on the CPU)
against the JAX package on the same inputs and weights, carried across by
``repro_torch.bridge``.

Tolerances: the wkv recurrence and one block 1e-5 (rtol and atol, as
``tests/test_kernels.py`` sets for the Pallas wkv kernel): both sides run
the same f32 recurrence, summed in other orders. Logits 1e-4 absolute on
logits of magnitude ~1: two f32 layers, each a recurrence and seven
projections summed in other orders (observed ~1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import replay_greedy

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.core import hetero as jhetero
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.kernels.rwkv6_wkv import ops as jwkv_ops
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtfm
from repro_torch import bridge, kernels
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import hetero, lora, quant
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import kvcache, rwkv
from repro_torch.models import transformer as tfm
from repro_torch.serve.api import Request, make_engine

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False   # f32 reference products
KEY = jax.random.PRNGKey(0)
WKV_TOL = 1e-5
LOGIT_TOL = 1e-4
N_NEW = 3


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce_config(jax_get_config("rwkv6-7b"))
    cfg = reduce_config(get_config("rwkv6-7b"))
    base = jtfm.init_params(jcfg, KEY)
    # smoke weights fall under quantize_params' default min_size
    m8f8 = jquant.quantize_params(base, JaxQuantConfig(8, 8), min_size=1)
    ads = [jlora.init_lora_params(jcfg, jax.random.fold_in(KEY, i + 1))
           for i in range(2)]
    # B starts at zero: shift every leaf so each adapter changes the output
    ads = [jax.tree.map(lambda x, s=0.05 * (i + 1): x + s, a)
           for i, a in enumerate(ads)]
    return {"jcfg": jcfg, "cfg": cfg,
            "jax": {"plain": base, "m8f8": m8f8},
            "torch": {"plain": _to_torch(base), "m8f8": _to_torch(m8f8)},
            "jads": ads, "tads": [_to_torch(a) for a in ads]}


# ---------------------------------------------------------------------------
# the wkv recurrence
# ---------------------------------------------------------------------------


def _wkv_inputs(B, T, H, N, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, N)))) * 0.5
         + 0.45).astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,T,H,N,bt", [(2, 96, 4, 16, 32), (1, 64, 2, 32, 64),
                                        (1, 50, 3, 8, 16)])
def test_wkv_plain_matches_jax_scan_and_pallas(B, T, H, N, bt):
    """The sweep of tests/test_kernels.py, through the port's wrapper (the
    plain version on CPU tensors), against JAX ``wkv_scan`` and the Pallas
    kernel in interpret mode; y and s_final."""
    args = _wkv_inputs(B, T, H, N, B * T * H * N)
    y_scan, s_scan = jrwkv.wkv_scan(*map(jnp.asarray, args))
    y_pl, s_pl = jwkv_ops.rwkv6_wkv(*map(jnp.asarray, args), block_t=bt)
    kernels.reset_launches()
    y, s = wkv_ops.rwkv6_wkv(*map(torch.from_numpy, args))
    assert kernels.LAUNCHES["rwkv6_wkv"] == 0     # the CPU runs no kernel
    for y_ref, s_ref in ((y_scan, s_scan), (y_pl, s_pl)):
        _close(y, y_ref, WKV_TOL)
        _close(s, s_ref, WKV_TOL)


def test_wkv_ragged_rows_with_an_empty_row():
    """Steps masked as the model masks them (k = 0, w = 1) leave the state
    unchanged: a row with an empty chunk returns s0 exactly, and every row's
    s_final equals the state after its valid steps alone."""
    B, T, H, N = 3, 12, 2, 16
    r, k, v, w, u, s0 = _wkv_inputs(B, T, H, N, 5)
    clens = np.array([12, 5, 0])
    valid = (np.arange(T)[None] < clens[:, None])[..., None, None]
    k, w = np.where(valid, k, 0.0), np.where(valid, w, 1.0)
    args = tuple(a.astype(np.float32) for a in (r, k, v, w, u, s0))
    y, s = wkv_ops.rwkv6_wkv(*map(torch.from_numpy, args))
    y_ref, s_ref = jrwkv.wkv_scan(*map(jnp.asarray, args))
    _close(y, y_ref, WKV_TOL)
    _close(s, s_ref, WKV_TOL)
    assert torch.equal(s[2], torch.from_numpy(s0[2]))
    _, s_short = wkv_ops.rwkv6_wkv_plain(
        *(torch.from_numpy(a[1:2, :5]) for a in (r, k, v, w)),
        torch.from_numpy(u), torch.from_numpy(s0[1:2]))
    _close(s[1:2], s_short, WKV_TOL)


def test_wkv_refuses_what_it_does_not_take():
    args = [torch.from_numpy(a) for a in _wkv_inputs(1, 4, 2, 16, 0)]
    with pytest.raises(ValueError, match="u"):
        wkv_ops.rwkv6_wkv(*args[:4], args[4][:1], args[5])
    # no silent fallback: a tensor that is neither on the CPU nor on CUDA
    with pytest.raises(ValueError):
        wkv_ops.rwkv6_wkv(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="impl"):
        rwkv.wkv_scan(*args, impl="pallas")


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def test_rwkv_block_with_cache_ragged_and_idle_rows_matches_jax(setup):
    """Nonzero incoming state, chunk_lens (5, 2, 0, 1) over a chunk of 5:
    the row with an empty chunk keeps its state; one LoRA adapter on the
    receptance and value projections."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp = jtfm.init_params(jcfg, jax.random.fold_in(KEY, 7))["layers"][0]
    jp = jax.tree.map(lambda a: a[0], jp)             # one layer
    ab = jax.tree.map(lambda a: a[0], setup["jads"][1]["layers"][0])
    B, T, d = 4, 5, cfg.d_model
    H, N = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    cache = {"shift_t": rng.standard_normal((B, d)).astype(np.float32),
             "shift_c": rng.standard_normal((B, d)).astype(np.float32),
             "wkv": (0.1 * rng.standard_normal((B, H, N, N))).astype(
                 np.float32)}
    clens = np.array([5, 2, 0, 1], np.int32)
    for chunk_lens in (None, clens):
        jx, jc = jrwkv.apply_rwkv_block(
            jcfg, jp, jnp.asarray(x),
            cache=jax.tree.map(jnp.asarray, cache), lora=ab,
            chunk_lens=None if chunk_lens is None else jnp.asarray(chunk_lens))
        tx, tc = rwkv.apply_rwkv_block(
            cfg, _to_torch(jp), torch.from_numpy(x),
            cache=_to_torch(cache), lora=_to_torch(ab),
            chunk_lens=(None if chunk_lens is None
                        else torch.from_numpy(chunk_lens)))
        _close(tx, jx, WKV_TOL)
        for name in rwkv.SLOT_STATE_LEAVES:
            _close(tc[name], jc[name], WKV_TOL)
    for name in rwkv.SLOT_STATE_LEAVES:     # the idle row is untouched
        np.testing.assert_array_equal(tc[name][2].numpy(), cache[name][2])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base", ["plain", "m8f8"])
def test_prefill_then_decode_logits_match_jax(setup, base):
    """Three rows on two adapters, without and with the M8F8 base: whole
    prefill, then token-by-token decode over the dense state cache."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp, tp = setup["jax"][base], setup["torch"][base]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    idx = np.array([1, 0, 1])
    jkw = dict(lora=jlora.stack_adapters(setup["jads"]),
               adapter_idx=jnp.asarray(idx))
    tkw = dict(lora=lora.stack_adapters(setup["tads"]),
               adapter_idx=torch.as_tensor(idx))
    lj, cj, _ = jtfm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                             mode="prefill", **jkw)
    lt, ct, _ = tfm.forward(cfg, tp, {"tokens": torch.as_tensor(toks)},
                            mode="prefill", **tkw)
    _close(lt, lj, LOGIT_TOL)
    for name in rwkv.SLOT_STATE_LEAVES:
        _close(ct["layers"][0][name], cj["layers"][0][name], LOGIT_TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
        lj, cj, _ = jtfm.forward(jcfg, jp, {"tokens": jnp.asarray(nxt)},
                                 mode="decode", cache=cj, **jkw)
        lt, ct2, _ = tfm.forward(cfg, tp, {"tokens": torch.as_tensor(nxt)},
                                 mode="decode", cache=ct, **tkw)
        assert ct2 is ct                        # state updated in place
        _close(lt, lj, LOGIT_TOL)
    _close(ct["layers"][0]["wkv"], cj["layers"][0]["wkv"], LOGIT_TOL)


def test_train_mode_flop_tally_matches_jax_unrolled(setup):
    """The Eq. 5 tally (static vs dynamic engine, nonlinear elements),
    including the wkv recurrence's 4 B T H N^2, equals JAX's over an
    unrolled forward (the JAX tally counts a scanned body once)."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    idx = np.array([1, 0])
    jkw = dict(lora=jlora.stack_adapters(setup["jads"]),
               adapter_idx=jnp.asarray(idx))

    def jfwd(p):
        return jtfm.forward(jcfg, p, {"tokens": jnp.asarray(toks)},
                            exec_cfg=jtfm.ExecConfig(scan_layers=False),
                            **jkw)[0]

    lj = jfwd(setup["jax"]["m8f8"])
    with hetero.tally() as t:
        lt, _, _ = tfm.forward(cfg, setup["torch"]["m8f8"],
                               {"tokens": torch.as_tensor(toks)},
                               lora=lora.stack_adapters(setup["tads"]),
                               adapter_idx=torch.as_tensor(idx))
    _close(lt, lj, LOGIT_TOL)
    report = jhetero.breakdown_of(jfwd, setup["jax"]["m8f8"])
    assert t[hetero.STATIC] == report.static_flops
    assert t[hetero.DYNAMIC] == report.dynamic_flops
    assert t["nonlinear"] == report.nonlinear_elems


def test_ref_impl_equals_auto_on_the_cpu(setup):
    """rwkv_impl="ref" (the plain recurrence anywhere) and "auto" (the
    wrapper, which on the CPU runs the same plain version) agree."""
    cfg = setup["cfg"]
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32))
    la, _, _ = tfm.forward(cfg, setup["torch"]["plain"], {"tokens": toks})
    lr, _, _ = tfm.forward(cfg, setup["torch"]["plain"], {"tokens": toks},
                           exec_cfg=tfm.ExecConfig(rwkv_impl="ref"))
    assert torch.equal(la, lr)


def test_config_and_init_layout_match_jax(setup):
    """The config copy equals JAX's field for field (full and reduced), and
    init_params builds JAX's tree: same paths, shapes and dtypes (f32
    w_base and u), seeded by the generator."""
    for jc, tc in ((jax_get_config("rwkv6-7b"), get_config("rwkv6-7b")),
                   (setup["jcfg"], setup["cfg"])):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    cfg = setup["cfg"]
    a = tfm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = tfm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    ref = setup["torch"]["plain"]

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree

    la, lb, lr = list(leaves(a)), list(leaves(b)), list(leaves(ref))
    assert [p for p, _ in la] == [p for p, _ in lr]
    for (p, x), (_, y), (_, r) in zip(la, lb, lr):
        assert x.shape == r.shape and x.dtype == r.dtype, p
        assert torch.equal(x, y), p
    tm = a["layers"][0]["time_mix"]
    torch.testing.assert_close(tm["w_base"], ref["layers"][0]["time_mix"]
                               ["w_base"])
    torch.testing.assert_close(tm["mu"], ref["layers"][0]["time_mix"]["mu"])


def test_bridge_and_quantize_params_agree_on_the_crossbar_leaves(setup):
    """The bridged M8F8 tree carries int8 crossbar codes for r/k/v/g/o and
    ck/cv, and f32 leaves (w_base, u, cr_proj, the LoRA-style mixes);
    the port's quantize_params picks exactly the same leaves."""
    from repro.core.quant import QuantizedTensor as JaxQuantizedTensor

    def flags(tree, is_q, path=()):
        if is_q(tree):
            return {path: True}
        if isinstance(tree, dict):
            return {p: f for k in tree
                    for p, f in flags(tree[k], is_q, path + (k,)).items()}
        if isinstance(tree, (tuple, list)):
            return {p: f for i, v in enumerate(tree)
                    for p, f in flags(v, is_q, path + (i,)).items()}
        return {path: False}

    bridged = setup["torch"]["m8f8"]
    ported = quant.quantize_params(setup["torch"]["plain"], QuantConfig(8, 8),
                                   min_size=1)
    want = flags(setup["jax"]["m8f8"],
                 lambda t: isinstance(t, JaxQuantizedTensor))
    assert flags(bridged, quant.is_quantized) == want
    assert flags(ported, quant.is_quantized) == want
    tm = bridged["layers"][0]["time_mix"]
    cm = bridged["layers"][0]["channel_mix"]
    assert {n for part in (tm, cm) for n, leaf in part.items()
            if quant.is_quantized(leaf)} == {"r_proj", "k_proj", "v_proj",
                                             "g_proj", "o_proj", "ck_proj",
                                             "cv_proj"}
    assert tm["r_proj"].codes.dtype == torch.int8
    for leaf in (tm["w_base"], tm["u"], cm["cr_proj"]):
        assert leaf.dtype == torch.float32


def test_cache_layouts_match_jax_and_reset_slots_zeroes_rows(setup):
    """init_cache / init_paged_cache build JAX's leaves (names, shapes,
    dtypes: shifts in the kv dtype, wkv in f32), and reset_slots zeroes
    the given rows of every per-slot leaf in place."""
    from repro.models import kvcache as jkv
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    layout = kvcache.PagedLayout(page_size=4, num_pages=8, max_slots=3)
    jlayout = jkv.PagedLayout(page_size=4, num_pages=8, max_slots=3)
    pairs = ((jkv.init_cache(jcfg, 2, 16, kv_dtype=jnp.float32),
              kvcache.init_cache(cfg, 2, 16, device="cpu")),
             (jkv.init_paged_cache(jcfg, jlayout, 16),
              kvcache.init_paged_cache(cfg, layout, 16, device="cpu")))
    for jc, tc in pairs:
        for je, te in zip(jc["layers"], tc["layers"]):
            assert set(je) == set(te)
            for name in je:
                assert tuple(je[name].shape) == tuple(te[name].shape), name
                assert str(je[name].dtype) == str(te[name].dtype)[6:], name
    cache = pairs[1][1]
    for leaf in cache["layers"][0].values():
        leaf.fill_(1.0)
    assert kvcache.reset_slots(cache, [1]) is cache
    for leaf in cache["layers"][0].values():
        assert torch.all(leaf[:, 1] == 0) and torch.all(leaf[:, [0, 2]] == 1)


def test_slot_state_arena_zeroes_only_the_given_slots(setup):
    cfg = setup["cfg"]
    layout = kvcache.PagedLayout(page_size=4, num_pages=8, max_slots=3)
    cache = kvcache.init_paged_cache(cfg, layout, 32, device="cpu")
    assert set(cache["layers"][0]) == set(rwkv.SLOT_STATE_LEAVES)
    for leaf in cache["layers"][0].values():
        leaf.fill_(1.0)
    arena = kvcache.SlotStateArena(cfg)
    assert arena.tracked
    assert arena.reset(cache, [0, 2]) is cache
    for leaf in cache["layers"][0].values():
        assert torch.all(leaf[:, [0, 2]] == 0) and torch.all(leaf[:, 1] == 1)
    llama = reduce_config(get_config("llama3.2-1b"))
    assert not kvcache.SlotStateArena(llama).tracked


# ---------------------------------------------------------------------------
# the paged engine against the replay oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle(setup):
    memo = {}

    def expected(prompt, adapter_id, max_len, max_new=N_NEW, eos_id=None):
        key = (tuple(int(t) for t in prompt), adapter_id, max_len, max_new,
               eos_id)
        if key not in memo:
            memo[key] = replay_greedy(setup["jcfg"], setup["jax"]["m8f8"],
                                      setup["jads"], prompt, max_new,
                                      adapter_id=adapter_id, max_len=max_len,
                                      eos_id=eos_id)
        return memo[key]

    return expected


def _serve(setup, oracle, prompts, **engine_kw):
    eng = make_engine(setup["cfg"], setup["torch"]["m8f8"], setup["tads"],
                      mode="paged", device="cpu", record_logits=True,
                      **engine_kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=N_NEW,
                           adapter_id=i % 2))
    done = eng.drain()
    assert sorted(done) == list(range(len(prompts)))
    for i, p in enumerate(prompts):
        assert list(done[i].tokens) == oracle(p, i % 2,
                                              engine_kw["max_len"]), i
        rows = torch.stack(eng.sampled_logits[i])
        assert rows.argmax(-1).tolist() == list(done[i].tokens)
    eng.sched.alloc.check_invariants()
    assert eng.sched.alloc.used_pages == 0
    return eng.stats()


def test_engine_chunked_prefill_and_slot_recycling_match_replay_oracle(
        setup, oracle):
    """Five requests on two slots (each slot serves several requests in
    turn, zeroed through arena.reset at admission), prompts of 3 to 19
    tokens in chunks of 8, two of them sharing a 9-token head: the prefix
    cache stays off for the recurrent model."""
    rng = np.random.default_rng(0)
    vocab = setup["cfg"].vocab_size
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (3, 19, 11, 6)]
    prompts.append(np.concatenate([prompts[1][:9], rng.integers(
        0, vocab, 4).astype(np.int32)]))
    st = _serve(setup, oracle, prompts, max_slots=2, max_len=32,
                page_size=8, prefill_chunk=8)
    assert not st.prefix_cache.enabled and st.prefix_cache.hit_tokens == 0
    assert st.prefill_tokens == sum(len(p) for p in prompts)


def test_engine_forced_preemption_matches_replay_oracle(setup, oracle):
    """A pool of 5 pages of 4 tokens cannot hold two growing requests:
    the youngest is preempted, readmitted to a zeroed slot, re-prefilled
    from its stream, and still matches."""
    rng = np.random.default_rng(5)
    vocab = setup["cfg"].vocab_size
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (9, 7, 10, 6)]
    st = _serve(setup, oracle, prompts, max_slots=3, max_len=24,
                page_size=4, num_pages=5, prefill_chunk=4)
    assert st.scheduler.preemptions >= 1


@pytest.mark.parametrize("case", ["eos", "length_cap", "prompt_of_max_len_1"])
def test_engine_end_of_request_matches_replay_oracle(setup, oracle, case):
    """The three ways a request ends, each held against the replay oracle
    with the same stopping rules: an ``eos_id`` stop (the eos token is the
    third greedy token), a request cut by the length cap (40 new tokens
    asked, ``max_len`` 16), and a prompt of ``max_len - 1`` tokens (two
    tokens: the prefill's and one decode)."""
    rng = np.random.default_rng(11)
    vocab = setup["cfg"].vocab_size
    max_len, eos_id = 16, None
    if case == "eos":
        prompt, max_new = rng.integers(0, vocab, 5), 8
        eos_id = oracle(prompt, 1, max_len, max_new)[2]
    elif case == "length_cap":
        prompt, max_new = rng.integers(0, vocab, 5), 40
    else:
        prompt, max_new = rng.integers(0, vocab, max_len - 1), 5
    prompt = prompt.astype(np.int32)
    eng = make_engine(setup["cfg"], setup["torch"]["m8f8"], setup["tads"],
                      device="cpu", max_slots=2, max_len=max_len,
                      page_size=4, prefill_chunk=4)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=max_new,
                       adapter_id=1, eos_id=eos_id))
    done = eng.drain()[0]
    want = oracle(prompt, 1, max_len, max_new, eos_id)
    assert list(done.tokens) == want
    if case == "eos":
        assert done.finish_reason == "eos" and want[-1] == eos_id
        assert len(want) < max_new
    else:
        assert done.finish_reason == "length" and len(want) < max_new
    if case == "prompt_of_max_len_1":
        assert len(want) == 2
    eng.sched.alloc.check_invariants()
    assert eng.sched.alloc.used_pages == 0
