"""jamba-1.5-large-398b (Mamba + attention, MoE FFs) in the port, on the
CPU (plain kernel versions), against the JAX package on the same weights
(carried across by ``repro_torch.bridge``):

  * the logits of a prefill and of the decode steps after it (M8F8 base,
    two adapters on wq, wv, mamba_in and mamba_out);
  * the paged engine at two chunk widths and under preemption, the dense
    engine, and n-gram speculation (with recurrent rollbacks of the Mamba
    state): greedy tokens equal ``tests/oracle.replay_greedy``'s (the JAX
    package's token-at-a-time replay);
  * ``SlotStateArena`` snapshot, restore and reset on the conv and ssm
    leaves; the bridge's and ``init_quantized_params``' Mamba leaves;
  * a LoRA train step: the loss and every LoRA gradient (mamba_in's
    among them) against JAX's ``value_and_grad``, and a ``Trainer`` step's
    loss.

Reduced jamba: 16 layers (two scan periods of 1 attention and 7 Mamba
layers, MoE FFs on the odd ones), d 64, d_in 128, d_state 4, 4 experts
top-2. Every prompt has the same length (12: a 3-token motif tiled), so
the oracle's jitted forward compiles once, and each oracle is computed
once; over 8 new tokens the greedy streams repeat tokens, so the n-gram
drafter drafts (and is rejected).

Tolerances: logits 1e-5 (rtol and atol) on logits of magnitude ~1:
16 f32 layers whose scans and products sum in other orders; the loss
1e-5 relative and each LoRA gradient 1e-4 in relative L2 norm, as
``tests/test_torch_train.py`` holds llama.
"""
import dataclasses
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
from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.data import pipeline as jpipeline
from repro.models import transformer as jtfm
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import lora, quant
from repro_torch.data import pipeline
from repro_torch.models import kvcache, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.kvcache import PagedLayout, SlotStateArena
from repro_torch.optim import adamw
from repro_torch.serve.api import Request, make_engine
from repro_torch.serve.spec import SpecConfig
from repro_torch.train import steps, trainer

torch.set_num_threads(2)
ARCH = "jamba-1.5-large-398b"
KEY = jax.random.PRNGKey(6)
TOL = 1e-5
N_NEW = 8
PROMPT_LEN = 12
TARGETS = ("wq", "wv", "mamba_in", "mamba_out")


def _prompt(seed):
    motif = np.random.default_rng(20 + seed).integers(1, 257, 3)
    return np.tile(motif, PROMPT_LEN // 3).astype(np.int32)


PROMPTS = [_prompt(s) for s in range(3)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    return bridge.to_torch(_np(tree), "cpu")


def _with_targets(cfg):
    return dataclasses.replace(cfg, lora=dataclasses.replace(
        cfg.lora, targets=TARGETS))


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


@pytest.fixture(scope="module")
def m():
    jcfg = _with_targets(jax_reduce_config(jax_get_config(ARCH)))
    cfg = _with_targets(reduce_config(get_config(ARCH)))
    base = jax.jit(functools.partial(jtfm.init_params, jcfg))(KEY)
    params = jquant.quantize_params(base, JaxQuantConfig(8, 8), min_size=1)
    ad0 = jax.jit(functools.partial(jlora.init_lora_params, jcfg))(
        jax.random.fold_in(KEY, 1))
    ads = [jax.tree.map(lambda x, s=s: x + s, ad0) for s in (0.05, 0.1)]
    memo = {}

    def expected(i, adapter_id):
        if (i, adapter_id) not in memo:
            memo[(i, adapter_id)] = replay_greedy(
                jcfg, params, ads, PROMPTS[i], N_NEW, adapter_id=adapter_id,
                max_len=48)
        return memo[(i, adapter_id)]

    jtfm.forward = _jit_forward         # the oracle's forward, jitted
    try:
        yield SimpleNamespace(jcfg=jcfg, cfg=cfg, jbase=base, jparams=params,
                              jads=ads, params=_to_torch(params),
                              adapters=[_to_torch(a) for a in ads],
                              expected=expected)
    finally:
        jtfm.forward = _FORWARD


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_prefill_then_decode_logits_match_jax(m):
    """Two rows on two adapters: a whole prefill (the Mamba state and the
    conv tail start at zero), then 3 decode steps over the dense cache,
    which the port updates in place."""
    toks = np.stack(PROMPTS[:2])
    idx = np.array([1, 0])
    jkw = dict(lora=jlora.stack_adapters(m.jads), adapter_idx=jnp.asarray(idx))
    tkw = dict(lora=lora.stack_adapters(m.adapters),
               adapter_idx=torch.as_tensor(idx))
    lj, cj, _ = _jit_forward(m.jcfg, m.jparams, {"tokens": jnp.asarray(toks)},
                             mode="prefill", prefill_cache_len=16, **jkw)
    lt, ct, _ = tfm.forward(m.cfg, m.params, {"tokens": torch.as_tensor(toks)},
                            mode="prefill", prefill_cache_len=16, **tkw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                               atol=TOL)
    for name in ssm.SLOT_STATE_LEAVES:
        np.testing.assert_allclose(ct["layers"][1][name].numpy(),
                                   np.asarray(cj["layers"][1][name]),
                                   rtol=TOL, atol=TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
        lj, cj, _ = _jit_forward(m.jcfg, m.jparams,
                                 {"tokens": jnp.asarray(nxt)}, mode="decode",
                                 cache=cj, **jkw)
        lt, ct2, _ = tfm.forward(m.cfg, m.params,
                                 {"tokens": torch.as_tensor(nxt)},
                                 mode="decode", cache=ct, **tkw)
        assert ct2 is ct
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------------------------------------
# the engines against the replay oracle
# ---------------------------------------------------------------------------


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
    assert st.moe.enabled and st.moe.dropped_tokens == 0
    return eng, st


@pytest.mark.parametrize("chunk", [4, 16])
def test_paged_engine_matches_oracle(m, chunk):
    """Two slots for three requests (a slot is recycled and its Mamba
    state zeroed at admission); the prefix cache is off on a model with
    per-slot state."""
    _, st = _serve(m, max_slots=2, page_size=4, prefill_chunk=chunk)
    assert not st.prefix_cache.enabled


def test_paged_engine_matches_oracle_under_preemption(m):
    """Pages of 3 in a pool of 10: the younger request is preempted,
    readmitted to a zeroed slot and recomputed in other chunks."""
    _, st = _serve(m, max_slots=2, page_size=3, num_pages=10,
                   prefill_chunk=5, enable_prefix_cache=False)
    assert st.scheduler.preemptions >= 1


def test_dense_engine_matches_oracle(m):
    _serve(m, mode="dense", max_batch=3)


def test_spec_ngram_matches_oracle_with_recurrent_rollbacks(m):
    """n-gram drafts over the motif-tiled prompts: a rejected draft
    restores the slots' conv and ssm state from the verify step's snapshot
    and replays the accepted prefix; the tokens are the oracle's."""
    _, st = _serve(m, max_slots=3, page_size=8, prefill_chunk=8,
                   spec=SpecConfig(k=4, drafter="ngram"))
    assert st.spec.enabled and st.spec.drafted_tokens > 0
    assert st.spec.recurrent_rollbacks > 0
    assert st.spec.rolled_back_tokens == (st.spec.drafted_tokens
                                          - st.spec.accepted_tokens)


# ---------------------------------------------------------------------------
# per-slot state, the bridge and the quantized init
# ---------------------------------------------------------------------------


def test_slot_state_arena_snapshot_restore_reset():
    """restore() selects per slot between the post-chunk state and the
    snapshot, reset() zeroes exactly the tracked rows; the conv and ssm
    leaves of every Mamba position are tracked, the page pool never."""
    cfg = reduce_config(get_config(ARCH))
    arena = SlotStateArena(cfg)
    assert arena.leaves[0] == ()
    assert all(arena.leaves[p] == ssm.SLOT_STATE_LEAVES for p in range(1, 8))
    cache = kvcache.init_paged_cache(
        cfg, PagedLayout(page_size=4, num_pages=4, max_slots=3), 16,
        device="cpu")
    for entry, names in zip(cache["layers"], arena.leaves):
        for nm, leaf in entry.items():
            leaf.fill_(1.0 if nm in names else 7.0)
    ckpt = arena.snapshot(cache)
    orig = [{nm: leaf.clone() for nm, leaf in e.items()}
            for e in cache["layers"]]
    for entry in cache["layers"]:
        for leaf in entry.values():
            leaf.add_(100.0)
    mutated = [{nm: leaf.clone() for nm, leaf in e.items()}
               for e in cache["layers"]]
    arena.restore(cache, ckpt, torch.tensor([True, False, True]))
    for entry, names, o, mu in zip(cache["layers"], arena.leaves, orig,
                                   mutated):
        for nm, leaf in entry.items():
            if nm in names:     # slot 1 restored, slots 0 and 2 kept
                assert torch.equal(leaf[:, 1], o[nm][:, 1])
                assert torch.equal(leaf[:, 0], mu[nm][:, 0])
                assert torch.equal(leaf[:, 2], mu[nm][:, 2])
            else:               # the pool passes through untouched
                assert torch.equal(leaf, mu[nm])
    arena.reset(cache, [1])
    for entry, names, mu in zip(cache["layers"], arena.leaves, mutated):
        for nm in names:
            assert not entry[nm][:, 1].any()
            assert torch.equal(entry[nm][:, 0], mu[nm][:, 0])


def test_bridge_carries_the_mamba_leaves(m):
    """The JAX M8F8 tree's quantized in_proj/out_proj become the port's
    QuantizedTensors with the same codes (the port's quantize_params of
    the bridged f32 base gives them bit for bit); x_proj and dt_proj stay
    f32, as ``WEIGHT_CLASS`` has them."""
    jm = _np(m.jparams["layers"][1]["mamba"])
    tm = m.params["layers"][1]["mamba"]
    requant = quant.quantize_params(_to_torch(m.jbase), QuantConfig(8, 8),
                                    min_size=1)["layers"][1]["mamba"]
    for name in ("in_proj", "out_proj"):
        assert quant.is_quantized(tm[name])
        np.testing.assert_array_equal(tm[name].codes.numpy(),
                                      jm[name].codes)
        np.testing.assert_array_equal(tm[name].scales.numpy(),
                                      jm[name].scales)
        assert torch.equal(requant[name].codes, tm[name].codes)
    for name in ("x_proj", "dt_proj", "conv_w", "dt_bias", "A_log", "D"):
        assert not quant.is_quantized(tm[name])
        np.testing.assert_array_equal(tm[name].numpy(), jm[name])


def test_init_quantized_params_quantizes_each_leaf_as_it_is_drawn(
        monkeypatch):
    """One leaf at a time: every quantized matrix goes through the leaf
    hook as soon as it is drawn (the safety-net ``quantize_params`` pass
    finds nothing left to quantize), and the codes are those of drawing a
    scan period in f32 and quantizing it whole."""
    cfg = reduce_config(get_config(ARCH))
    qc = QuantConfig(8, 4)
    seen = []
    real = quant.quantize_leaf

    def hooked(key, w, *a, **kw):
        out = real(key, w, *a, **kw)
        seen.append(quant.is_quantized(out) and isinstance(w, torch.Tensor))
        return out

    monkeypatch.setattr(quant, "quantize_leaf", hooked)
    got = tfm.init_quantized_params(cfg, torch.Generator().manual_seed(1),
                                    qc, device="cpu", min_size=1)
    monkeypatch.undo()
    g = torch.Generator().manual_seed(1)
    periods = [quant.quantize_params(tfm._init_layers(cfg, g, 1,
                                                      device="cpu",
                                                      dtype=torch.float32),
                                     qc, min_size=1)
               for _ in range(cfg.n_layers // 8)]
    n_quantized = 0
    for pos, entry in enumerate(got["layers"]):
        for sp, want in enumerate(periods):
            a, b = lora.layer_slice(entry, sp), lora.layer_slice(
                want[pos], 0)
            for leaf_a, leaf_b in zip(_leaves(a), _leaves(b)):
                if quant.is_quantized(leaf_b):
                    n_quantized += 1
                    assert torch.equal(leaf_a.codes, leaf_b.codes)
                    assert torch.equal(leaf_a.scales, leaf_b.scales)
                else:
                    assert torch.equal(leaf_a, leaf_b)
    # one hook call per quantized matrix and period, each while drawn
    assert sum(seen) == n_quantized
    assert quant.is_quantized(got["layers"][1]["ff"]["w1"])
    assert quant.is_quantized(got["layers"][1]["mamba"]["in_proj"])


def _leaves(tree):
    if quant.is_quantized(tree) or isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])


# ---------------------------------------------------------------------------
# LoRA training
# ---------------------------------------------------------------------------


def test_lora_loss_and_mamba_grads_match_jax(m):
    """The loss and every LoRA gradient (wq/wv on the attention layers,
    mamba_in/mamba_out on the Mamba ones) of one batch, against
    ``value_and_grad`` of the JAX loss, B != 0; then one ``Trainer`` step
    on the same batch reports the same loss."""
    rng = np.random.default_rng(12)
    jl = _np(jlora.init_lora_params(m.jcfg, jax.random.fold_in(KEY, 3)))
    for entry in jl["layers"]:
        for ab in entry.values():
            ab["b"] = (0.02 * rng.standard_normal(ab["b"].shape)).astype(
                np.float32)
    assert set(jl["layers"][1]) == {"mamba_in", "mamba_out"}
    jb = jpipeline.SyntheticLM(m.cfg.vocab_size, seed=3).batch(0, 2, 12)
    tb = {k: torch.from_numpy(v) for k, v in jb.items()}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(m.jcfg, jtfm.ExecConfig()), has_aux=True))(
            jax.tree.map(jnp.asarray, jl), m.jparams,
            jax.tree.map(jnp.asarray, jb), None)
    tl = bridge.to_torch(jl, "cpu")
    (tloss, _), tg = steps.value_and_grad(
        steps.make_loss_fn(m.cfg, tfm.ExecConfig()), tl, m.params, tb, None)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jleaves, tleaves = jax.tree.leaves(jg), list(adamw.leaves(tg))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(b) > 0
        err = np.linalg.norm(a.numpy().astype(np.float64) - b)
        assert err <= 1e-4 * np.linalg.norm(b)
    gin = tg["layers"][1]["mamba_in"]["a"]
    assert float(gin.abs().max()) > 0
    tc = trainer.TrainerConfig(seq_len=12, global_batch=2, steps=1,
                               log_every=100, ckpt_every=20)
    tr = trainer.Trainer(m.cfg, tc, pipeline.SyntheticLM(m.cfg.vocab_size,
                                                         seed=3),
                         params=m.params, device="cpu")
    tr.lora = bridge.to_torch(jl, "cpu")
    (rec,) = tr.run()
    assert abs(rec["loss"] - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert np.isfinite(rec["grad_norm"])
