"""LoRA fine-tuning of rwkv6-7b in the port against the JAX package, on
the CPU.

Reduced rwkv6-7b (2 layers, d 64), the JAX weights, LoRA tree and
optimizer state carried across with ``repro_torch.bridge``. On the CPU
the wkv recurrence's gradient comes from ``WkvFn``, whose backward is
``rwkv6_wkv_bwd_plain``: the formulas of the CUDA backward kernel. JAX
differentiates its chunk-checkpointed ``wkv_scan``.

Tolerances, as ``tests/test_torch_train.py`` holds llama: the loss 1e-5
relative, each LoRA gradient 1e-4 in relative L2 norm (f32 through two
layers, the products summed in another order); the trainer's losses 1e-5
relative and its final LoRA 1e-4 (max abs) after three steps. Remat on
against off: the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.data import pipeline as jpipeline
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro.train import trainer as jtrainer
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.noise import NoiseConfig
from repro_torch.data import pipeline
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.train import steps, trainer

torch.set_num_threads(2)
ARCH = "rwkv6-7b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _setup(quantized, seed=0):
    """JAX weights (dense or M8F8) and a LoRA tree on r_proj/v_proj (the
    rwkv block's wq/wv) with B != 0, in both packages."""
    jcfg = jreduce_config(jget_config(ARCH))
    cfg = reduce_config(get_config(ARCH))
    key = jax.random.PRNGKey(seed)
    jparams = jtfm.init_params(jcfg, key)
    if quantized:
        jparams = jquant.quantize_params(jparams, JQuantConfig(8, 8),
                                         min_size=1)
    jl = _np(jlora.init_lora_params(jcfg, jax.random.fold_in(key, 1)))
    rng = np.random.default_rng(seed + 5)
    for entry in jl["layers"]:
        for ab in entry.values():
            ab["b"] = (0.02 * rng.standard_normal(ab["b"].shape)).astype(
                np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                jlora=jax.tree.map(jnp.asarray, jl),
                params=bridge.to_torch(_np(jparams), "cpu"),
                lora=bridge.to_torch(jl, "cpu"))


def _batch(vocab, B=4, T=24, seed=3):
    b = jpipeline.SyntheticLM(vocab, seed=seed).batch(0, B, T)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "m8f8"])
def test_rwkv_loss_and_lora_grads_match_jax(quantized):
    """The loss and every LoRA gradient against ``value_and_grad`` of the
    JAX loss; the wkv gradient goes through ``WkvFn``."""
    s = _setup(quantized)
    jb, tb = _batch(s["cfg"].vocab_size)
    (jl, jm), jg = jax.value_and_grad(
        jsteps.make_loss_fn(s["jcfg"], jtfm.ExecConfig()), has_aux=True)(
            s["jlora"], s["jparams"], jax.tree.map(jnp.asarray, jb), None)
    (tl, tm), tg = steps.value_and_grad(
        steps.make_loss_fn(s["cfg"], tfm.ExecConfig()), s["lora"],
        s["params"], tb, None)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(tm["tokens"]) == float(jm["tokens"])
    jleaves, tleaves = jax.tree.leaves(jg), list(adamw.leaves(tg))
    assert len(jleaves) == len(tleaves) == (
        2 * len(s["cfg"].lora.targets))
    for a, b in zip(tleaves, jleaves):
        assert np.linalg.norm(np.asarray(b)) > 0
        assert _rel(a.numpy(), b) <= 1e-4


def test_rwkv_wkv_backward_runs_through_wkvfn(monkeypatch):
    """The train-mode forward sends the recurrence through ``WkvFn`` (one
    backward call per layer and microbatch), and ``rwkv_impl="ref"``
    (plain autograd of the recurrence) gives the same loss and
    gradients."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    s = _setup(True)
    _, tb = _batch(s["cfg"].vocab_size)
    calls = []
    real = wkv_ops.rwkv6_wkv_bwd

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(wkv_ops, "rwkv6_wkv_bwd", counted)
    out = {}
    for impl in ("auto", "ref"):
        loss, _, g = steps.accumulate_grads(
            steps.make_loss_fn(s["cfg"], tfm.ExecConfig(rwkv_impl=impl)),
            s["lora"], s["params"], tb, 2)
        out[impl] = (loss, list(adamw.leaves(g)))
    assert len(calls) == 2 * s["cfg"].n_layers
    (la, ga), (lr, gr) = out["auto"], out["ref"]
    assert abs(float(la) - float(lr)) <= 1e-6 * abs(float(lr))
    for a, b in zip(ga, gr):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5


def test_rwkv_trainer_three_steps_match_jax():
    """Three ``Trainer`` steps on an M8F8 base, 2 microbatches: the
    losses, then the LoRA."""
    s = _setup(True)
    kw = dict(seq_len=16, global_batch=4, steps=3, log_every=100,
              ckpt_every=20)
    jtc = jtrainer.TrainerConfig(hparams=jsteps.TrainHParams(
        microbatches=2, adamw=jadamw.AdamWConfig(
            lr=1e-3, schedule=jadamw.warmup_cosine(1, 3))), **kw)
    tc = trainer.TrainerConfig(hparams=steps.TrainHParams(
        microbatches=2, adamw=adamw.AdamWConfig(
            lr=1e-3, schedule=adamw.warmup_cosine(1, 3))), **kw)
    jtr = jtrainer.Trainer(s["jcfg"], jtc, jpipeline.SyntheticLM(
        s["cfg"].vocab_size, seed=3), params=s["jparams"])
    tr = trainer.Trainer(s["cfg"], tc, pipeline.SyntheticLM(
        s["cfg"].vocab_size, seed=3), params=s["params"], device="cpu")
    tr.lora = bridge.to_torch(_np(jtr.lora), "cpu")
    tr.opt_state = bridge.opt_state_to_torch(_np(jtr.opt_state), "cpu")
    jlog, tlog = jtr.run(), tr.run()
    assert [r["step"] for r in tlog] == [1, 2, 3]
    for a, b in zip(tlog, jlog):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        assert np.isfinite(a["grad_norm"])
    for a, b in zip(adamw.leaves(tr.lora), jax.tree.leaves(jtr.lora)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
def test_rwkv_remat_gives_the_same_bits(noise):
    """``ExecConfig(remat=True)``: the loss and every LoRA gradient of a
    step in 2 microbatches are bit-equal to those without remat, with
    weight noise (sigma_rel 0.02) off and on; the generator ends where it
    ends without remat."""
    s = _setup(True)
    _, tb = _batch(s["cfg"].vocab_size)
    runs = []
    for remat in (False, True):
        ec = tfm.ExecConfig(remat=remat, noise=NoiseConfig(
            enabled=noise, sigma_rel=0.02))
        rng = torch.Generator().manual_seed(11) if noise else None
        loss, _, g = steps.accumulate_grads(
            steps.make_loss_fn(s["cfg"], ec), s["lora"], s["params"], tb, 2,
            rng)
        runs.append((loss, list(adamw.leaves(g)),
                     rng.get_state() if noise else None))
    (l0, g0, st0), (l1, g1, st1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    if noise:
        assert torch.equal(st0, st1)


def test_launcher_trains_rwkv_at_smoke_size_on_the_cpu(capsys):
    from repro_torch.launch import train as launch_train
    log = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--steps", "3", "--batch", "2", "--seq", "16",
                             "--quant", "M8F8", "--microbatches", "2"])
    assert len(log) == 3 and all(np.isfinite(r["loss"]) for r in log)
    assert "quantized base (M8F8)" in capsys.readouterr().out
