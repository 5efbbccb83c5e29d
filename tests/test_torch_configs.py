"""The six architectures the port gains with its configs, qk-norm and the
embeddings frontend (CPU, plain kernel versions), against the JAX package
on the same weights (carried across by ``repro_torch.bridge``):

  * ``get_config`` resolves mixtral-8x22b, llama4-scout-17b-a16e,
    internlm2-20b, mistral-nemo-12b, musicgen-medium, chameleon-34b and
    jamba-1.5-large-398b, field for field as JAX's, full and reduced;
  * qk-norm (reduced chameleon-34b): prefill from tokens then decode over
    the dense cache, logits and the normed, roped K in the cache;
  * the embeddings frontend (reduced musicgen-medium and chameleon-34b):
    a forward from ``{"embeds": ...}``, and a train step's loss and every
    LoRA gradient from an embeds batch against JAX's ``value_and_grad``.

Tolerances: 1e-4 on logits (``tests/test_torch_model.py``), 1e-5 relative
on the loss and 1e-4 relative L2 on each gradient
(``tests/test_torch_train.py``). JAX calls are jitted.
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
from repro.core import lora as jlora
from repro.models import transformer as jtfm
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.core import lora
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.train import steps

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(5)
TOL = 1e-4
NEW_ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e", "internlm2-20b",
             "mistral-nemo-12b", "musicgen-medium", "chameleon-34b",
             "jamba-1.5-large-398b")


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_match_jax_field_for_field(arch):
    jc, tc = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (dataclasses.asdict(jax_reduce_config(jc))
            == dataclasses.asdict(reduce_config(tc)))
    assert arch in ARCH_IDS


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = jax_reduce_config(jax_get_config(arch))
    params = jax.jit(functools.partial(jtfm.init_params, jcfg))(KEY)
    ad = jax.jit(functools.partial(jlora.init_lora_params, jcfg))(
        jax.random.fold_in(KEY, 1))
    ad = jax.tree.map(lambda x: x + 0.1, ad)        # B != 0
    return (jcfg, reduce_config(get_config(arch)), params, ad,
            _to_torch(params), _to_torch(ad))


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def test_qk_norm_prefill_then_decode_matches_jax():
    jcfg, cfg, jp, jad, tp, tad = _model("chameleon-34b")
    assert cfg.attn.qk_norm and tp["layers"][0]["attn"]["q_norm"].shape[-1] \
        == cfg.hd
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 7))
    jkw = dict(lora=jlora.stack_adapters([jad]), adapter_idx=jnp.zeros(2, int))
    tkw = dict(lora=lora.stack_adapters([tad]),
               adapter_idx=torch.zeros(2, dtype=torch.long))
    jfwd = jax.jit(jtfm.forward, static_argnums=0,
                   static_argnames=("mode", "prefill_cache_len"))
    lj, cj, _ = jfwd(jcfg, jp, {"tokens": jnp.asarray(toks)}, mode="prefill",
                     prefill_cache_len=10, **jkw)
    lt, ct, _ = tfm.forward(cfg, tp, {"tokens": torch.as_tensor(toks)},
                            mode="prefill", prefill_cache_len=10, **tkw)
    _close(lt, lj)
    _close(ct["layers"][0]["k"], cj["layers"][0]["k"])
    for _ in range(2):
        nxt = np.array(jnp.argmax(lj[:, -1], -1))[:, None]
        lj, cj, _ = jfwd(jcfg, jp, {"tokens": jnp.asarray(nxt)},
                         mode="decode", cache=cj, **jkw)
        lt, ct, _ = tfm.forward(cfg, tp, {"tokens": torch.as_tensor(nxt)},
                                mode="decode", cache=ct, **tkw)
        _close(lt, lj)
    _close(ct["layers"][0]["k"], cj["layers"][0]["k"])


@pytest.mark.parametrize("arch", ["musicgen-medium", "chameleon-34b"])
def test_embeds_forward_matches_jax(arch):
    jcfg, cfg, jp, jad, tp, tad = _model(arch)
    assert cfg.frontend == "embeddings"
    emb = np.random.default_rng(2).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    lj = jax.jit(lambda p, e: jtfm.forward(jcfg, p, {"embeds": e})[0])(
        jp, jnp.asarray(emb))
    lt, _, aux = tfm.forward(cfg, tp, {"embeds": torch.as_tensor(emb)})
    _close(lt, lj)
    assert float(aux["lb_loss"]) == 0.0


def _rel(a, b):
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ["musicgen-medium", "chameleon-34b"])
def test_embeds_train_loss_and_lora_grads_match_jax(arch):
    jcfg, cfg, jp, jad, tp, tad = _model(arch)
    rng = np.random.default_rng(3)
    batch = {"embeds": rng.standard_normal((2, 8, cfg.d_model))
             .astype(np.float32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 8))
             .astype(np.int32),
             "mask": (rng.random((2, 8)) > 0.2).astype(np.float32)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jcfg, jtfm.ExecConfig()), has_aux=True))(
            jad, jp, jax.tree.map(jnp.asarray, batch), None)
    (tl, tm), tg = steps.value_and_grad(
        steps.make_loss_fn(cfg, tfm.ExecConfig()), tad, tp,
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(tm["tokens"]) == float(jm["tokens"])
    assert float(tm["lb_loss"]) == float(jm["lb_loss"]) == 0.0
    jleaves, tleaves = jax.tree.leaves(jg), list(adamw.leaves(tg))
    # stacked over the scan periods: an A and a B per target and position
    assert len(jleaves) == len(tleaves) == 2 * len(cfg.lora.targets) * (
        cfg.period)
    for a, b in zip(tleaves, jleaves):
        assert np.linalg.norm(np.asarray(b)) > 0
        assert _rel(a.numpy(), b) <= 1e-4
