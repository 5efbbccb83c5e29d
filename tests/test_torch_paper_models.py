"""Port parity for the paper's own evaluation models (Atleus SS V.A):
GPT-2 (Medium) and BLOOM-560m shaped decoders with LayerNorm, 16/16-head
attention and a tanh-GELU MLP.

Configs match the JAX package field for field. On smoke shapes (2 layers,
d 64, 4/4 heads, d_ff 128, the published vocabularies of 50257 and 250880)
the port's GELU MLP, ``forward`` (plain and M8F8) and FLOP tally match the
JAX package on the same weights, carried across by ``repro_torch.bridge``;
the Table II and Fig. 7 scripts' counts equal the closed forms and the JAX
tally; and the paged engine's greedy tokens equal
``tests/oracle.replay_greedy``.

Tolerances: 1e-5 on the MLP's outputs (one f32 product pair and the GELU,
sums in another order); 1e-4 on logits, as ``tests/test_torch_model.py``.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import replay_greedy

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.configs import shapes as jshapes
from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.configs.paper_models import PAPER_DIMS as JAX_PAPER_DIMS
from repro.core import hetero as jhetero
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, cell_supported,
                                 get_config, reduce_config)
from repro_torch.configs.paper_models import PAPER_DIMS
from repro_torch.core import hetero, lora
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.serve.api import Request, make_engine

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False   # f32 reference products
KEY = jax.random.PRNGKey(0)
TOL = 1e-4
MLP_TOL = 1e-5
PAPER = ("paper-gpt2-medium", "paper-bloom-560m")


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _reduced(get, reduce, name):
    """Smoke shapes at the model's published vocabulary (not a multiple of
    128: 50257, 250880)."""
    return reduce(get(name), vocab=get(name).vocab_size)


@pytest.fixture(scope="module", params=PAPER)
def model(request):
    name = request.param
    jcfg = _reduced(jax_get_config, jax_reduce_config, name)
    cfg = _reduced(get_config, reduce_config, name)
    base = jtfm.init_params(jcfg, KEY)
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


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PAPER)
def test_paper_config_matches_jax_field_for_field(name):
    jc, tc = jax_get_config(name), get_config(name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (dataclasses.asdict(jax_reduce_config(jc))
            == dataclasses.asdict(reduce_config(tc)))
    assert (tc.mlp, tc.norm, tc.tie_embeddings) == ("gelu", "layernorm", True)
    # resolved by name, but not an assigned architecture, on both sides
    assert name not in ARCH_IDS and name not in JAX_ARCH_IDS


def test_paper_dims_and_shape_suites_match_jax():
    assert PAPER_DIMS == JAX_PAPER_DIMS
    assert ([dataclasses.astuple(s) for s in ALL_SHAPES]
            == [dataclasses.astuple(s) for s in jshapes.ALL_SHAPES])
    assert [s.tokens for s in ALL_SHAPES] == [s.tokens
                                              for s in jshapes.ALL_SHAPES]
    for name in PAPER + ARCH_IDS:
        jc, tc = jax_get_config(name), get_config(name)
        for js, ts in zip(jshapes.ALL_SHAPES, ALL_SHAPES):
            assert cell_supported(tc, ts) == jshapes.cell_supported(jc, js)


def test_waiting_architectures_still_raise():
    """No architecture waits any more: every one the JAX package registers
    resolves in the port, in the JAX package's order."""
    assert ARCH_IDS == JAX_ARCH_IDS
    for name in JAX_ARCH_IDS:
        assert get_config(name).name == jax_get_config(name).name


# ---------------------------------------------------------------------------
# the GELU MLP
# ---------------------------------------------------------------------------


def test_gelu_init_mlp_draws_w1_then_w2_and_has_no_gate():
    cfg = reduce_config(get_config("paper-gpt2-medium"))
    kw = dict(device="cpu", dtype=torch.float32)
    p = layers.init_mlp(cfg, torch.Generator().manual_seed(3), **kw)
    assert sorted(p) == ["w1", "w2"]
    g = torch.Generator().manual_seed(3)
    w1 = layers.dense_init(g, (cfg.d_model, cfg.d_ff), **kw)
    w2 = layers.dense_init(g, (cfg.d_ff, cfg.d_model), fan_in=cfg.d_ff, **kw)
    assert torch.equal(p["w1"], w1) and torch.equal(p["w2"], w2)
    # gemma2's gated GELU draws a gate between them; an unknown MLP raises
    gated = dataclasses.replace(cfg, mlp="gated_gelu")
    pg = layers.init_mlp(gated, torch.Generator().manual_seed(3), **kw)
    assert list(pg) == ["w1", "w3", "w2"] and torch.equal(pg["w1"], w1)
    with pytest.raises(ValueError, match="unknown mlp"):
        layers.init_mlp(dataclasses.replace(cfg, mlp="relu"),
                        torch.Generator(), **kw)


@pytest.mark.parametrize("base", ["plain", "m8f8"])
def test_gelu_apply_mlp_matches_jax(model, base):
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp = model["jax"][base]["layers"][0]["ff"]
    tp = model["torch"][base]["layers"][0]["ff"]
    jp1 = jax.tree.map(lambda x: x[1], jp)        # the second layer's slice
    tp1 = lora.layer_slice(tp, 1)
    x = np.random.default_rng(2).standard_normal((3, 7, cfg.d_model))
    x = x.astype(np.float32)
    with jhetero.tally() as jt:
        want = jlayers.apply_mlp(jcfg, jp1, jnp.asarray(x))
    with hetero.tally() as tt:
        got = layers.apply_mlp(cfg, tp1, torch.as_tensor(x))
    _close(got, want, MLP_TOL)
    assert dict(tt) == dict(jt)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base", ["plain", "m8f8"])
def test_prefill_then_decode_logits_match_jax(model, base):
    """Two rows, each on its own adapter: a prefill, then two decode steps
    over the dense cache."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp, tp = model["jax"][base], model["torch"][base]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    idx = np.array([1, 0])
    jkw = dict(lora=jlora.stack_adapters(model["jads"]),
               adapter_idx=jnp.asarray(idx))
    tkw = dict(lora=lora.stack_adapters(model["tads"]),
               adapter_idx=torch.as_tensor(idx))
    lj, cj, _ = jtfm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                             mode="prefill", prefill_cache_len=12, **jkw)
    lt, ct, _ = tfm.forward(cfg, tp, {"tokens": torch.as_tensor(toks)},
                            mode="prefill", prefill_cache_len=12, **tkw)
    assert lt.shape == (2, 9, cfg.vocab_size)
    _close(lt, lj)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
        lj, cj, _ = jtfm.forward(jcfg, jp, {"tokens": jnp.asarray(nxt)},
                                 mode="decode", cache=cj, **jkw)
        lt, ct, _ = tfm.forward(cfg, tp, {"tokens": torch.as_tensor(nxt)},
                                mode="decode", cache=ct, **tkw)
        _close(lt, lj)


def test_flop_tally_matches_jax_breakdown_of(model):
    """The port's ``breakdown_of`` (it runs the forward) against the JAX
    one (it traces it) with the layers unrolled: the JAX tally counts a
    ``lax.scan`` body once."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    toks = toks.astype(np.int32)

    def jfwd(p, ads):
        return jtfm.forward(jcfg, p, {"tokens": jnp.asarray(toks)}, lora=ads,
                            exec_cfg=jtfm.ExecConfig(scan_layers=False))[0]

    def tfwd(p, ads):
        return tfm.forward(cfg, p, {"tokens": torch.as_tensor(toks)},
                           lora=ads)[0]

    want = jhetero.breakdown_of(jfwd, model["jax"]["m8f8"], model["jads"][0])
    got = hetero.breakdown_of(tfwd, model["torch"]["m8f8"], model["tads"][0])
    assert isinstance(got, hetero.BreakdownReport)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.static_share, got.ratio) == (want.static_share, want.ratio)


# ---------------------------------------------------------------------------
# Table II and Fig. 7 scripts
# ---------------------------------------------------------------------------


def _bench(name, tmp_path, monkeypatch):
    for common in ("benchmarks.common", "benchmarks.torch_common"):
        monkeypatch.setattr(importlib.import_module(common), "OUT", tmp_path)
    return importlib.import_module(f"benchmarks.{name}")


def test_table2_counts_equal_closed_forms_and_jax(tmp_path, monkeypatch):
    got = _bench("torch_kernel_complexity", tmp_path, monkeypatch).run("cpu")
    want = _bench("bench_kernel_complexity", tmp_path, monkeypatch).run()
    mha, ff = got["mha"], got["ff"]
    assert mha["static"] == mha["static_expected"]
    assert mha["dynamic"] == mha["dynamic_expected"]
    assert ff["static"] == ff["expected"]
    assert (mha, ff) == (want["mha"], want["ff"])
    assert (tmp_path / "torch_tableII_complexity.json").exists()


def test_fig7_analytic_part_equals_jax_and_tally_counts_every_layer(
        tmp_path, monkeypatch):
    got = _bench("torch_compute_breakdown", tmp_path, monkeypatch).run("cpu")
    want = _bench("bench_compute_breakdown", tmp_path, monkeypatch).run()
    for name in PAPER_DIMS:
        assert got[name] == want[name]
    # the JAX script's own forward, with the layers unrolled
    jcfg = jax_reduce_config(jax_get_config("paper-gpt2-medium"),
                             n_periods=2, d_model=256, n_heads=8, d_ff=1024)
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    ads = jlora.init_lora_params(jcfg, jax.random.PRNGKey(1))
    toks = {"tokens": jnp.zeros((1, 256), jnp.int32)}
    rep = jhetero.breakdown_of(
        lambda p, a: jtfm.forward(jcfg, p, toks, lora=a, mode="train",
                                  exec_cfg=jtfm.ExecConfig(
                                      scan_layers=False))[0], params, ads)
    traced = got["traced_gpt2m_reduced"]
    assert traced["static_flops"] == rep.static_flops
    assert traced["dynamic_flops"] == rep.dynamic_flops
    assert traced["static_share_pct"] == rep.static_share * 100
    # the scanned JAX tally counts one of the two layers
    assert want["traced_gpt2m_reduced"]["static_flops"] < rep.static_flops


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------


def test_engine_greedy_tokens_equal_replay_oracle():
    """Reduced paper-gpt2-medium on an M8F8 base with two adapters: mixed
    prompt lengths, and three prompts that share a 13-token head (pages of
    8: one full page and five tokens into the second, forked copy-on-write
    at the first divergent token)."""
    jcfg = _reduced(jax_get_config, jax_reduce_config, "paper-gpt2-medium")
    cfg = _reduced(get_config, reduce_config, "paper-gpt2-medium")
    base = jquant.quantize_params(jtfm.init_params(jcfg, KEY),
                                  JaxQuantConfig(8, 8), min_size=1)
    ad0 = jlora.init_lora_params(jcfg, jax.random.fold_in(KEY, 1))
    ad1 = jax.tree.map(lambda x: x + 0.3, ad0)
    rng = np.random.default_rng(4)
    head = rng.integers(0, cfg.vocab_size, 13)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (4, 17)] + [
        np.concatenate([head, rng.integers(0, cfg.vocab_size, t)])
        for t in (0, 3, 6)]
    prompts = [p.astype(np.int32) for p in prompts]
    adapter_of = [0, 1, 1, 1, 0]
    max_len, n_new = 40, 3
    eng = make_engine(cfg, _to_torch(base), [_to_torch(ad0), _to_torch(ad1)],
                      device="cpu", max_slots=3, max_len=max_len, page_size=8,
                      prefill_chunk=8, record_logits=True)
    for i, p in enumerate(prompts[:3]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=n_new,
                           adapter_id=adapter_of[i]))
    done = eng.drain()        # the head itself finishes first: it donates
    for i, p in enumerate(prompts[3:], start=3):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=n_new,
                           adapter_id=adapter_of[i]))
    done.update(eng.drain())
    assert sorted(done) == list(range(len(prompts)))
    for i, p in enumerate(prompts):
        want = replay_greedy(jcfg, base, [ad0, ad1], p, n_new,
                             adapter_id=adapter_of[i], max_len=max_len)
        assert list(done[i].tokens) == want, i
        rows = torch.stack(eng.sampled_logits[i])
        assert rows.shape[-1] == cfg.vocab_size
        assert rows.argmax(-1).tolist() == want
    st = eng.stats()
    assert st.prefix_cache.hit_tokens > 0 and st.scheduler.cow_forks >= 1
    eng.release_prefix_cache()
    assert eng.sched.alloc.used_pages == 0
