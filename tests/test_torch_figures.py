"""The paper-figure scripts of the port that run the model, piece by piece
against the JAX package, on the CPU: Fig. 13's full-parameter pretrain
step, its MnFm quantization, an M4F4 LoRA step and its perplexity
evaluation (``benchmarks/torch_quant_perplexity.py`` against
``benchmarks/bench_quant_perplexity.py``); Fig. 9's accuracy evaluation
and its noisy draw (``benchmarks/torch_noise.py`` against
``benchmarks/bench_noise.py``); the serving-throughput workloads 1-3 and 5
(``benchmarks/torch_serve_throughput.py``) at the JAX script's smoke sizes.
Weights are JAX's, carried across by ``repro_torch.bridge``; the Fig.
config (reduced paper-gpt2-medium, 2 layers, d 128) in f32.

Tolerances: the pretrain loss 1e-5 relative and each leaf's gradient 1e-4
relative L2 (f32 through two layers, products summed in another order);
the LoRA step's loss 1e-5 and its updated adapter 1e-4 (max abs); the
evaluations 1e-5 relative (perplexity) and exact (accuracy: argmax over a
vocabulary of 257, no tie within f32 noise on these weights).
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bench_noise as jnoise  # noqa: E402
from benchmarks import bench_quant_perplexity as jqppl  # noqa: E402
from benchmarks import torch_noise  # noqa: E402
from benchmarks import torch_quant_perplexity as qppl  # noqa: E402
from benchmarks import torch_serve_throughput  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_config as jreduce_config  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train.steps import TrainHParams as JTrainHParams  # noqa: E402
from repro.train.steps import make_train_step as jmake_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import TrainHParams, make_train_step  # noqa: E402

torch.set_num_threads(2)
MNFM = {"M8F8": (8, 8), "M8F4": (8, 4), "M4F8": (4, 8), "M4F4": (4, 4)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jcfg():
    return jreduce_config(jget_config("paper-gpt2-medium"), n_periods=2,
                          d_model=128, n_heads=4, d_ff=512)


@pytest.fixture(scope="module")
def fig():
    """The Fig. config in both packages, JAX's initial base and a LoRA
    tree whose B is not 0 (so the adapter moves the outputs)."""
    jcfg = _jcfg()
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    lora = jlora.init_lora_params(jcfg, jax.random.PRNGKey(1))
    lora = jax.tree.map(lambda x: x + 0.05, lora)
    return jcfg, qppl.config(), params, lora


def test_pretrain_step_matches_jax_value_and_grad(fig):
    """Fig. 13's full-parameter step: the loss and the gradient of every
    base leaf (embedding, LayerNorms, attention and MLP weights) against
    ``jax.value_and_grad`` of the JAX script's loss, then one AdamW update
    of the whole tree."""
    jcfg, cfg, params, _ = fig
    b = JSyntheticLM(jcfg.vocab_size, seed=2).batch(0, 16, 64)
    assert all(np.array_equal(b[k], v) for k, v in
               SyntheticLM(cfg.vocab_size, seed=2).batch(0, 16, 64).items())

    def loss_fn(p):
        lg, _, _ = jtfm.forward(jcfg, p, {"tokens": jnp.asarray(b["tokens"])},
                                mode="train")
        return jtfm.lm_loss(jcfg, lg, jnp.asarray(b["labels"]))[0]

    jloss, jg = jax.value_and_grad(loss_fn)(params)
    tparams = bridge.to_torch(_np(params), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, g = qppl.loss_and_grads(cfg, tparams, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jleaves = jax.tree.leaves(jg)
    leaves = list(adamw.leaves(g))
    assert len(leaves) == len(jleaves) == 13
    for a, w in zip(leaves, jleaves):
        assert a.shape == w.shape
        assert _rel(a.numpy(), w) <= 1e-4
    # one AdamW step over every leaf, from the same gradients
    jnew, _, _ = jadamw.apply_updates(JAdamWConfig(lr=2e-3), params, jg,
                                      jadamw.init(params))
    new, _, _ = adamw.apply_updates(AdamWConfig(lr=2e-3), tparams,
                                    bridge.to_torch(_np(jg), "cpu"),
                                    adamw.init(tparams))
    for a, w in zip(adamw.leaves(new), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("tag", sorted(MNFM))
def test_quantize_params_is_bit_exact_with_jax(fig, tag):
    """``quantize_params(min_size=1)`` of the Fig. base at each MnFm: the
    same leaves quantized, codes and scales bit for bit."""
    jcfg, cfg, params, _ = fig
    jq = jquant.quantize_params(params, JQuantConfig(*MNFM[tag]), min_size=1)
    tq = qppl.quantized(bridge.to_torch(_np(params), "cpu"), tag)
    jl = jax.tree.leaves(jq, is_leaf=lambda x: isinstance(
        x, jquant.QuantizedTensor))
    tl = list(adamw.leaves(tq))
    assert len(jl) == len(tl) == 13
    n_quant = 0
    for j, t in zip(jl, tl):
        assert isinstance(j, jquant.QuantizedTensor) == quant.is_quantized(t)
        if quant.is_quantized(t):
            n_quant += 1
            assert t.bits == j.bits and tuple(t.orig_shape) == tuple(
                j.orig_shape)
            assert np.array_equal(t.codes.numpy(), np.asarray(j.codes))
            assert np.array_equal(t.scales.numpy(), np.asarray(j.scales))
    assert n_quant == 6                # wq wk wv wo w1 w2 (stacked)


def _jax_lora_step(jcfg, base, lora, b):
    step = jmake_train_step(jcfg, jtfm.ExecConfig(), JTrainHParams(
        adamw=JAdamWConfig(lr=3e-3)))
    return step(base, lora, jadamw.init(lora),
                {k: jnp.asarray(v) for k, v in b.items()},
                jax.random.PRNGKey(2))


def test_m4f4_lora_step_matches_jax(fig):
    """One LoRA step of the Fig. 13 fine-tune over an M4F4 base (int4
    codes through the crossbar matmul and its transpose): the loss and the
    updated adapter."""
    jcfg, cfg, params, lora = fig
    jbase = jquant.quantize_params(params, JQuantConfig(4, 4), min_size=1)
    b = JSyntheticLM(jcfg.vocab_size, seed=2).batch(1000, 16, 64)
    jlora_new, _, jm = _jax_lora_step(jcfg, jbase, lora, b)
    base = bridge.to_torch(_np(jbase), "cpu")
    tlora = bridge.to_torch(_np(lora), "cpu")
    step = make_train_step(cfg, qppl.tfm.ExecConfig(), TrainHParams(
        adamw=AdamWConfig(lr=3e-3)))
    new, _, m = step(base, tlora, adamw.init(tlora),
                     {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    for a, w in zip(adamw.leaves(new), jax.tree.leaves(jlora_new)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_evaluations_match_jax(fig, monkeypatch):
    """Fig. 9's accuracy (clean base, an adapter with B != 0) and Fig. 13's
    perplexity (an M4F4 base; the JAX script's fine-tune cut to 0 steps,
    so both evaluate the seed-1 adapter) on the same weights."""
    jcfg, cfg, params, lora = fig
    ds = SyntheticLM(cfg.vocab_size, seed=5)
    jacc = jnoise._eval_acc(jcfg, params, lora, JSyntheticLM(
        jcfg.vocab_size, seed=5), noisy=False)
    acc = torch_noise.eval_acc(cfg, bridge.to_torch(_np(params), "cpu"),
                               bridge.to_torch(_np(lora), "cpu"), ds, "cpu",
                               noisy=False)
    assert acc == jacc and 0.0 < acc < 1.0
    jbase = jquant.quantize_params(params, JQuantConfig(4, 4), min_size=1)
    monkeypatch.setattr(jqppl, "FT_STEPS", 0)
    jppl = jqppl._finetune_and_ppl(jcfg, jbase, JSyntheticLM(
        jcfg.vocab_size, seed=2))
    seed1 = jlora.init_lora_params(jcfg, jax.random.PRNGKey(1))
    ppl = qppl.eval_ppl(cfg, bridge.to_torch(_np(jbase), "cpu"),
                        bridge.to_torch(_np(seed1), "cpu"),
                        SyntheticLM(cfg.vocab_size, seed=2), "cpu")
    assert abs(ppl - jppl) <= 1e-5 * jppl


_DRAW = """
import sys, torch
sys.path[:0] = [{src!r}, {root!r}]
from benchmarks import torch_noise
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
cfg = torch_noise.config()
p = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
q = torch_noise.perturb(p, torch_noise.SIGMA, 7)
print([float((a - b).abs().sum()) for a, b in zip(adamw.leaves(q),
                                                  adamw.leaves(p))])
"""


def test_noisy_draw_is_the_same_in_fresh_processes(fig):
    """Fig. 9's noisy evaluation base: two fresh processes draw the same
    noise for every leaf, and the leaves perturbed are those the JAX
    script perturbs (at least 2 dimensions, more than 4096 elements)."""
    jcfg, _, params, _ = fig
    prog = _DRAW.format(src=str(ROOT / "src"), root=str(ROOT))
    outs = [subprocess.run([sys.executable, "-c", prog], capture_output=True,
                           text=True, check=True, timeout=300).stdout
            for _ in range(2)]
    assert outs[0] == outs[1]
    moved = [d > 0 for d in json.loads(outs[0].strip().splitlines()[-1])]
    want = [x.ndim >= 2 and x.size > 4096 for x in jax.tree.leaves(params)]
    assert moved == want and sum(want) == 7      # the table and 6 weights


def test_fig9_and_fig13_scripts_run_with_jax_payload_keys(monkeypatch):
    """Both scripts to the end on the CPU at a cut step count, with the
    JAX scripts' payload keys."""
    monkeypatch.setattr(torch_noise, "STEPS", 2)
    monkeypatch.setattr(qppl, "PRETRAIN_STEPS", 2)
    monkeypatch.setattr(qppl, "FT_STEPS", 1)
    p9 = torch_noise.run("cpu")
    assert {"sigma_rel", "ideal_acc", "naive_acc", "noise_aware_acc",
            "gap_naive_pct", "gap_aware_pct"} <= set(p9)
    assert p9["steps"] == 2 and p9["device"] == "cpu"
    p13 = qppl.run("cpu")
    assert {"pretrain_final_loss", "ppl", "ordering_ok"} <= set(p13)
    assert set(p13["ppl"]) == {"bf16", *MNFM}
    assert all(np.isfinite(v) for v in p13["ppl"].values())
    assert p13["steps"] == {"pretrain": 2, "finetune": 1}


def test_serve_throughput_smoke_runs_with_jax_payload_keys(monkeypatch):
    """Workloads 1-3 and 5 at the JAX script's smoke sizes on the CPU: the
    paged engine's, the prefix-cached engine's, the speculating engine's
    and the dropless MoE engine's greedy tokens equal the dense oracle's
    (and the capacity baseline drops), with the JAX script's payload keys
    for the four workloads."""
    monkeypatch.setenv("BENCH_SMOKE", "1")
    p = torch_serve_throughput.run("cpu")
    assert {"smoke", "workload", "dense", "paged",
            "decode_throughput_speedup", "meets_2x_target",
            "shared_prefix"} <= set(p)
    assert p["smoke"] and p["paged"]["greedy_matches_dense_oracle"]
    sp = p["shared_prefix"]
    assert sp["greedy_matches_dense_oracle"]
    assert {"nocache", "prefix_cache", "prefill_token_reduction",
            "prefix_hit_rate", "meets_2x_prefill_reduction"} <= set(sp)
    assert sp["prefix_cache"]["prefix_hit_tokens"] > 0
    assert p["dense"]["kv_bytes"] > p["paged"]["kv_bytes"] > 0
    sd = p["spec_decode"]
    assert sd["greedy_matches_dense_oracle"]
    assert {"drafter", "k", "spec_on", "spec_off_tok_per_s", "accept_rate",
            "tokens_per_decode_step", "decode_throughput_speedup"} <= set(sd)
    assert sd["spec_on"]["drafted_tokens"] > 0
    assert sd["spec_on"]["rolled_back_tokens"] == (
        sd["spec_on"]["drafted_tokens"] - sd["spec_on"]["accepted_tokens"])
    md = p["moe_dropless"]
    assert md["greedy_matches_dense_oracle"]
    assert md["dropless"]["dropped_tokens"] == 0
    assert md["capacity_dropped_tokens"] > 0
    assert set(p["waiting"]) == {"tensor_parallel", "spec_hybrid"}
