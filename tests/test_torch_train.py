"""LoRA fine-tuning in the port against the JAX package, on the CPU.

Every test starts both packages from the same state: JAX builds the
weights, the LoRA tree and the optimizer state, and ``repro_torch.bridge``
carries them across as numpy. The backward kernels' plain versions are
held against ``jax.grad`` of the JAX functions they mirror; the step,
AdamW, the data pipeline, the trainer and its checkpoints against the JAX
package's own. Reduced configs (2 layers, d 64).

Tolerances: crossbar dx 1e-4 of max |dx|, as for the forward (the plain
version multiplies by the dequantized weight, JAX autodiffs its
dequantize-then-dot; f32 sums in another order). Flash dq/dk/dv 1e-4
relative and absolute, as ``tests/test_attention.py`` holds JAX's custom
VJP to ``ref_attention``'s gradients. Loss 1e-5 relative, each LoRA
gradient 1e-4 in relative L2 norm: f32 through two layers, the products
summed in another order. AdamW 1e-6: the same f32 arithmetic in the same
order. The trainer's losses 1e-5 relative and its final LoRA 1e-4 (max
abs) after three steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import hetero as jhetero
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.data import pipeline as jpipeline
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jckpt
from repro.train import steps as jsteps
from repro.train import trainer as jtrainer
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import hetero, quant
from repro_torch.core.noise import NoiseConfig, apply_weight_noise
from repro_torch.data import pipeline
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.train import checkpoint, steps, trainer

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the backward kernels' plain versions against jax.grad
# ---------------------------------------------------------------------------

CB_SWEEP = [(32, 128, 128), (64, 256, 384), (100, 300, 130), (8, 520, 250)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mkn", CB_SWEEP)
def test_crossbar_backward_plain_matches_jax_grad(bits, mkn):
    """dx of x @ dequant(W): ``crossbar_matmul_t_plain`` and the backward
    of the wrapper, which sends an x that needs a gradient through the
    autograd Function on CPU tensors as on CUDA ones, both against
    ``jax.grad`` of JAX's ``static_matmul`` on the same codes."""
    M, K, N = mkn
    rng = np.random.default_rng(M + K + N + bits)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    gy = rng.standard_normal((M, N)).astype(np.float32)
    qj = jquant.quantize(jnp.asarray(w), bits)
    dx_j = np.asarray(jax.grad(lambda x: jnp.sum(
        jhetero.static_matmul(x, qj) * gy))(jnp.asarray(x)))
    qt = quant.quantize(torch.from_numpy(w), bits)
    g = torch.from_numpy(gy)
    got = [cb_ops.crossbar_matmul_t_plain(g, qt)]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = cb_ops.crossbar_matmul(xt, qt)
    assert type(y.grad_fn).__name__ == "CrossbarMatmulFnBackward"
    (y * g).sum().backward()
    got.append(xt.grad)
    atol = 1e-4 * float(np.abs(dx_j).max())
    for dx in got:
        np.testing.assert_allclose(dx.numpy(), dx_j, rtol=1e-4, atol=atol)


def _qkv(B, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    dout = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    return q, k, v, pos, dout


# (head dim, softcap, window): head dim 16 with and without a softcap; 128
# and 256 with gemma2-9b's softcap of 50 (its GQA group of 2, heads cut
# from 16/8 to 4/2)
FLASH_BWD_CASES = (
    [pytest.param(16, c, w, id=f"{c}-{w}") for c in (None, 30.0)
     for w in (None, 4)]
    + [pytest.param(D, 50.0, w, id=f"D{D}-50.0-{w}") for D in (128, 256)
       for w in (None, 4)])


@pytest.mark.parametrize("D,softcap,window", FLASH_BWD_CASES)
def test_flash_backward_plain_matches_jax_grad(D, softcap, window):
    """dq/dk/dv of ``flash_attention_bwd_plain`` (and of the wrapper, whose
    autograd Function runs it on CPU tensors) against ``jax.grad`` through
    JAX's
    ``blocked_attention`` (its custom VJP), GQA group 2; the forward's lse
    against the one JAX saves."""
    B, T, Hq, Hkv = 2, 48, 4, 2
    q, k, v, pos, dout = _qkv(B, T, Hq, Hkv, D, 7 + (window or 0))
    jpos = jnp.asarray(pos)

    def f(q, k, v):
        o = jattn.blocked_attention(q, k, v, jpos, jpos, window=window,
                                    softcap=softcap, block_kv=16)
        return jnp.sum(o * dout)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _, jlse = jattn._flash_fwd_impl(*map(jnp.asarray, (q, k, v)), jpos, jpos,
                                    window, softcap, 16)
    t = [torch.from_numpy(a) for a in (q, k, v, pos, dout)]
    out, lse = fa_ops.flash_attention_plain(*t[:3], t[3], t[3],
                                            window=window, softcap=softcap,
                                            with_lse=True)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, Hq, T),
                               rtol=1e-5, atol=1e-5)
    got = [fa_ops.flash_attention_bwd_plain(*t[:3], t[3], t[3], out, lse,
                                            t[4], window=window,
                                            softcap=softcap, block_kv=16)]
    qkv = [x.clone().requires_grad_(True) for x in t[:3]]
    o = fa_ops.flash_attention(*qkv, t[3], t[3], window=window,
                               softcap=softcap)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    (o * t[4]).sum().backward()
    got.append([x.grad for x in qkv])
    for grads in got:
        for a, b in zip(grads, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4)


# ---------------------------------------------------------------------------
# the loss and every LoRA gradient against value_and_grad(make_loss_fn)
# ---------------------------------------------------------------------------


def _setup(arch, quantized, seed=0):
    """JAX weights (dense or M8F8), a LoRA tree with B != 0 (at B = 0 the
    gradient of A is 0 and would hide a wrong dx), both packages' views."""
    jcfg = jreduce_config(jget_config(arch))
    cfg = reduce_config(get_config(arch))
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


def _batch(vocab, B=4, T=16, step=0, seed=3):
    b = jpipeline.SyntheticLM(vocab, seed=seed).batch(step, B, T)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "m8f8"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "paper-gpt2-medium",
                                  "gemma2-9b", "llama4-scout-17b-a16e",
                                  "mixtral-8x22b"])
def test_loss_and_lora_grads_match_jax(arch, quantized):
    s = _setup(arch, quantized)
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
    # A and B of each target in each layer of the scan period (gemma2's
    # period holds a sliding and a full layer)
    assert len(jleaves) == len(tleaves) == (
        2 * len(s["cfg"].lora.targets) * len(s["lora"]["layers"]))
    for a, b in zip(tleaves, jleaves):
        assert np.linalg.norm(np.asarray(b)) > 0
        assert _rel(a.numpy(), b) <= 1e-4


def test_train_step_with_microbatches_matches_jax():
    """One step of ``make_train_step`` (2 microbatches, clip on, a
    schedule): the new LoRA, the moments and the metrics."""
    s = _setup("llama3.2-1b", True)
    jb, tb = _batch(s["cfg"].vocab_size, B=4)
    jhp = jsteps.TrainHParams(microbatches=2, adamw=jadamw.AdamWConfig(
        lr=1e-3, schedule=jadamw.warmup_cosine(2, 10)))
    hp = steps.TrainHParams(microbatches=2, adamw=adamw.AdamWConfig(
        lr=1e-3, schedule=adamw.warmup_cosine(2, 10)))
    jout = jsteps.make_train_step(s["jcfg"], jtfm.ExecConfig(), jhp)(
        s["jparams"], s["jlora"], jadamw.init(s["jlora"]),
        jax.tree.map(jnp.asarray, jb), jax.random.PRNGKey(0))
    tout = steps.make_train_step(s["cfg"], tfm.ExecConfig(), hp)(
        s["params"], s["lora"], adamw.init(s["lora"]), tb)
    assert abs(float(tout[2]["loss"]) - float(jout[2]["loss"])) <= (
        1e-5 * abs(float(jout[2]["loss"])))
    for k in ("grad_norm", "lr"):
        assert abs(float(tout[2][k]) - float(jout[2][k])) <= (
            1e-4 * abs(float(jout[2][k])))
    # the moments carry the gradients' 1e-4 (relative L2); the new LoRA
    # moves by lr times a normalized step
    for a, b in zip(adamw.leaves((tout[0], tout[1].mu, tout[1].nu)),
                    jax.tree.leaves((jout[0], jout[1].mu, jout[1].nu))):
        assert _rel(a.numpy(), b) <= 1e-4


# ---------------------------------------------------------------------------
# AdamW, the schedule and the data pipeline
# ---------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    return {"layers": ({"wq": {"a": rng.standard_normal((2, 8, 4)),
                               "b": rng.standard_normal((2, 4, 8))}},),
            "x": rng.standard_normal((5,)) * scale}


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_matches_jax(clip):
    """Three updates with a warmup-cosine schedule and weight decay; with
    gradients of global norm ~30 the clip (when on) is active."""
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda a: a.astype(np.float32), _tree(rng))
    jcfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.01, grad_clip=clip,
                              schedule=jadamw.warmup_cosine(2, 10))
    tcfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.01, grad_clip=clip,
                             schedule=adamw.warmup_cosine(2, 10))
    jp, js = jax.tree.map(jnp.asarray, p), jadamw.init(
        jax.tree.map(jnp.asarray, p))
    tp = bridge.to_torch(p, "cpu")
    ts = adamw.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: a.astype(np.float32),
                         _tree(np.random.default_rng(10 + i), 3.0))
        jp, js, jm = jadamw.apply_updates(jcfg, jp, jax.tree.map(
            jnp.asarray, g), js)
        tp, ts, tm = adamw.apply_updates(tcfg, tp, bridge.to_torch(g, "cpu"),
                                         ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for a, b in zip(adamw.leaves((tp, ts.mu, ts.nu)),
                    jax.tree.leaves((jp, js.mu, js.nu))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_warmup_cosine_and_opt_state_bridge_match_jax():
    js, ts = jadamw.warmup_cosine(3, 20), adamw.warmup_cosine(3, 20)
    for step in range(0, 25):
        np.testing.assert_allclose(
            float(ts(torch.tensor(step, dtype=torch.int32))),
            float(js(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(1)
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), _tree(rng))
    st = jadamw.init(p)._replace(step=jnp.asarray(7, jnp.int32))
    back = bridge.opt_state_to_torch(_np(st), "cpu")
    assert isinstance(back, adamw.AdamWState) and int(back.step) == 7
    assert back.step.dtype == torch.int32
    for a, b in zip(adamw.leaves(back.mu), jax.tree.leaves(st.mu)):
        assert a.dtype == torch.float32 and a.shape == b.shape


def test_data_batches_are_bit_equal_to_jax(tmp_path):
    """SyntheticLM and the memmap dataset, across steps and shards."""
    for mk in (lambda m: m.SyntheticLM(257, seed=4),
               lambda m: m.make_dataset(257, 4)):
        j, t = mk(jpipeline), mk(pipeline)
        for step in (0, 3):
            for shard in (0, 1):
                a = j.batch(step, 8, 24, jpipeline.ShardInfo(shard, 2))
                b = t.batch(step, 8, 24, pipeline.ShardInfo(shard, 2))
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
    assert pipeline.SyntheticLM(257, 4).entropy_bound() == (
        jpipeline.SyntheticLM(257, 4).entropy_bound())
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 257, 4000).astype(np.int32).tofile(
        path)
    a = jpipeline.make_dataset(257, 2, str(path)).batch(2, 4, 32)
    b = pipeline.make_dataset(257, 2, str(path)).batch(2, 4, 32)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the trainer: steps, restarts and checkpoints across packages
# ---------------------------------------------------------------------------


def _trainers(tmp=None, steps_=3, ckpt_every=20, jtmp=None):
    """A JAX and a port Trainer on the same M8F8 weights and LoRA."""
    s = _setup("llama3.2-1b", True)
    kw = dict(seq_len=16, global_batch=4, steps=steps_, log_every=100,
              ckpt_every=ckpt_every)
    jtc = jtrainer.TrainerConfig(
        ckpt_dir=jtmp, hparams=jsteps.TrainHParams(
            microbatches=2, adamw=jadamw.AdamWConfig(
                lr=1e-3, schedule=jadamw.warmup_cosine(1, steps_))), **kw)
    tc = trainer.TrainerConfig(
        ckpt_dir=tmp, hparams=steps.TrainHParams(
            microbatches=2, adamw=adamw.AdamWConfig(
                lr=1e-3, schedule=adamw.warmup_cosine(1, steps_))), **kw)
    jtr = jtrainer.Trainer(s["jcfg"], jtc, jpipeline.SyntheticLM(
        s["cfg"].vocab_size, seed=3), params=s["jparams"])
    tr = trainer.Trainer(s["cfg"], tc, pipeline.SyntheticLM(
        s["cfg"].vocab_size, seed=3), params=s["params"], device="cpu")
    tr.lora = bridge.to_torch(_np(jtr.lora), "cpu")
    tr.opt_state = bridge.opt_state_to_torch(_np(jtr.opt_state), "cpu")
    return jtr, tr


def test_trainer_three_steps_match_jax():
    """Three steps with 2 microbatches: the losses, then the LoRA."""
    jtr, tr = _trainers()
    jlog, tlog = jtr.run(), tr.run()
    assert [r["step"] for r in tlog] == [1, 2, 3]
    for a, b in zip(tlog, jlog):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        assert np.isfinite(a["grad_norm"])
    for a, b in zip(adamw.leaves(tr.lora), jax.tree.leaves(jtr.lora)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


def test_trainer_restarts_after_a_step_hook_failure(tmp_path):
    """A failure injected at step 3 restores the checkpoint of step 2 and
    continues; the steps replayed from it give the uninterrupted losses
    (stateless data, restored LoRA and moments)."""
    _, clean = _trainers(steps_=5)
    ref = clean.run()
    _, tr = _trainers(str(tmp_path), steps_=5, ckpt_every=2)
    boom = {"armed": True}

    def hook(step):
        if step == 3 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected failure")

    tr._step_hook = hook
    log = tr.run_with_restarts()
    assert tr.fault.restarts == 1 and tr.step == 5
    assert [r["step"] for r in log] == [1, 2, 3, 3, 4, 5]
    assert checkpoint.latest_step(str(tmp_path)) == 4
    for a, b in zip(log[3:], ref[2:]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)


def test_checkpoints_restore_across_packages(tmp_path):
    """A checkpoint written by JAX's Trainer restores into the port bit for
    bit, and one written by the port restores into JAX's."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jtr, tr = _trainers(tdir, steps_=2, ckpt_every=2, jtmp=jdir)
    jtr.run()
    tr.run()
    jman, tman = jckpt.read_manifest(jdir), checkpoint.read_manifest(tdir)
    assert jman["keys"] == tman["keys"] and jman["step"] == tman["step"] == 2
    assert "['lora']['layers'][0]['wq']['a']" in tman["keys"]
    # JAX -> port
    jtr2, tr2 = _trainers(jdir, steps_=2, jtmp=tdir)
    assert tr2.maybe_restore() and tr2.step == 2
    for a, b in zip(adamw.leaves((tr2.lora, tr2.opt_state.mu,
                                  tr2.opt_state.nu)),
                    jax.tree.leaves((jtr.lora, jtr.opt_state.mu,
                                     jtr.opt_state.nu))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tr2.opt_state.step) == int(jtr.opt_state.step) == 2
    # port -> JAX
    assert jtr2.maybe_restore() and jtr2.step == 2
    for a, b in zip(jax.tree.leaves((jtr2.lora, jtr2.opt_state.mu)),
                    adamw.leaves((tr.lora, tr.opt_state.mu))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(jtr2.opt_state.step) == 2


def test_launcher_trains_at_smoke_size_on_the_cpu(capsys):
    log = launch_train.main(["--arch", "paper-gpt2-medium", "--smoke",
                             "--device", "cpu", "--steps", "3", "--batch",
                             "2", "--seq", "16", "--quant", "M8F8",
                             "--noise-sigma", "0.02", "--microbatches", "2"])
    assert len(log) == 3 and all(np.isfinite(r["loss"]) for r in log)
    assert "quantized base (M8F8)" in capsys.readouterr().out


def test_full_finetune_step_matches_jax():
    """``TrainHParams(full_finetune=True)``: the JAX package declares the
    flag and reads it nowhere, so its step trains the LoRA tree; the
    port's step does the same. One step each with the flag: the loss, the
    gradient norm, the new LoRA and the first moments (which hold (1 -
    b1) times the gradients) as in ``test_train_step_with_microbatches``."""
    s = _setup("llama3.2-1b", True)
    jb, tb = _batch(s["cfg"].vocab_size, B=4)
    jout = jsteps.make_train_step(
        s["jcfg"], jtfm.ExecConfig(),
        jsteps.TrainHParams(microbatches=2, full_finetune=True))(
            s["jparams"], s["jlora"], jadamw.init(s["jlora"]),
            jax.tree.map(jnp.asarray, jb), jax.random.PRNGKey(0))
    tout = steps.make_train_step(
        s["cfg"], tfm.ExecConfig(),
        steps.TrainHParams(microbatches=2, full_finetune=True))(
            s["params"], s["lora"], adamw.init(s["lora"]), tb)
    assert abs(float(tout[2]["loss"]) - float(jout[2]["loss"])) <= (
        1e-5 * abs(float(jout[2]["loss"])))
    assert abs(float(tout[2]["grad_norm"]) - float(jout[2]["grad_norm"])) <= (
        1e-4 * abs(float(jout[2]["grad_norm"])))
    tleaves = list(adamw.leaves((tout[0], tout[1].mu)))
    jleaves = jax.tree.leaves((jout[0], jout[1].mu))
    assert len(tleaves) == len(jleaves) == 4 * len(s["cfg"].lora.targets)
    for a, b in zip(tleaves, jleaves):
        assert _rel(a.numpy(), b) <= 1e-4


# ---------------------------------------------------------------------------
# weight noise
# ---------------------------------------------------------------------------


def test_weight_noise_statistics_and_clip():
    """sigma_rel = 0 leaves the weight as it is; otherwise the noise's std
    is within 5% of sigma_rel * absmax over a 256 x 256 weight, and the
    noisy weight lies within +-absmax."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    absmax = float(w.abs().max())
    gen = torch.Generator().manual_seed(0)
    same = apply_weight_noise(w, NoiseConfig(enabled=True, sigma_rel=0.0),
                              gen)
    assert torch.equal(same, w)
    assert apply_weight_noise(w, NoiseConfig(), None) is w
    noisy = apply_weight_noise(w, NoiseConfig(enabled=True, sigma_rel=0.05),
                               gen)
    std = float((noisy - w).std())
    assert abs(std - 0.05 * absmax) <= 0.05 * 0.05 * absmax
    assert float(noisy.abs().max()) <= absmax
    with pytest.raises(ValueError, match="Generator"):
        apply_weight_noise(w, NoiseConfig(enabled=True), None)


def test_noisy_static_matmul_is_a_dense_product_of_the_noisy_weight():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, 256)).astype(np.float32))
    qt = quant.quantize(w, 8)
    off = NoiseConfig(enabled=True, sigma_rel=0.0)
    np.testing.assert_allclose(
        hetero.static_matmul(x, qt, noise=off, rng=torch.Generator()).numpy(),
        hetero.static_matmul(x, qt).numpy(), rtol=1e-5, atol=1e-5)
    on = NoiseConfig(enabled=True, sigma_rel=0.02)
    y = hetero.static_matmul(x, qt, noise=on,
                             rng=torch.Generator().manual_seed(1))
    wn = apply_weight_noise(quant.dequantize(qt), on,
                            torch.Generator().manual_seed(1))
    np.testing.assert_allclose(y.numpy(), (x @ wn).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_noise_applies_in_train_mode_only():
    """Train-mode logits move under noise and stay finite; prefill ignores
    the noise config, as JAX's forward does."""
    s = _setup("llama3.2-1b", True)
    toks = {"tokens": torch.randint(0, s["cfg"].vocab_size, (2, 12),
                                    generator=torch.Generator().manual_seed(0))}
    ec = tfm.ExecConfig(noise=NoiseConfig(enabled=True, sigma_rel=0.02))
    base = tfm.forward(s["cfg"], s["params"], toks, lora=s["lora"])[0]
    noisy = tfm.forward(s["cfg"], s["params"], toks, lora=s["lora"],
                        exec_cfg=ec, rng=torch.Generator().manual_seed(0))[0]
    assert torch.isfinite(noisy).all() and not torch.equal(noisy, base)
    pre = tfm.forward(s["cfg"], s["params"], toks, lora=s["lora"],
                      mode="prefill", exec_cfg=ec)[0]
    torch.testing.assert_close(pre, base, rtol=1e-6, atol=1e-6)


def _remat_grads(cfg, params, lora, batch, remat, noise, microbatches=2):
    """(loss, LoRA gradients, the generator's state after the step) of
    one step's batch in ``microbatches``, with ``ExecConfig.remat`` on or
    off and weight noise (sigma_rel 0.02, from a seeded generator) on or
    off."""
    ec = tfm.ExecConfig(remat=remat, noise=NoiseConfig(
        enabled=noise, sigma_rel=0.02))
    rng = torch.Generator().manual_seed(7) if noise else None
    loss, _, grads = steps.accumulate_grads(
        steps.make_loss_fn(cfg, ec), lora, params, batch, microbatches, rng)
    return loss, list(adamw.leaves(grads)), (
        rng.get_state() if rng is not None else None)


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
def test_remat_gives_the_same_bits(noise, monkeypatch):
    """``ExecConfig(remat=True)`` on llama (M8F8, 2 microbatches): the
    loss and every LoRA gradient are bit-equal to those without remat,
    with weight noise off and on (the rerun draws the noise its period
    drew, and leaves the generator where the step without remat does);
    each layer's forward runs twice with remat, once without."""
    s = _setup("llama3.2-1b", True)
    _, tb = _batch(s["cfg"].vocab_size, B=4)
    runs = {}
    real = tfm._apply_position
    for remat in (False, True):
        ran = []

        def counted(*a, ran=ran, **kw):
            ran.append(a[2])
            return real(*a, **kw)

        monkeypatch.setattr(tfm, "_apply_position", counted)
        runs[remat] = (*_remat_grads(s["cfg"], s["params"], s["lora"], tb,
                                     remat, noise), len(ran))
    (l0, g0, st0, n0), (l1, g1, st1, n1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1) == 2 * len(s["cfg"].lora.targets)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    if noise:
        assert torch.equal(st0, st1)
    assert n0 == 2 * s["cfg"].n_layers and n1 == 2 * n0
