"""Port parity for the analytic Atleus model: ``repro_torch.perfmodel`` is a
copy of ``repro.perfmodel``, and every public constant and function of its
five modules returns the JAX package's numbers exactly (``==``) over the
paper's four models and the argument grids the figure scripts use. Each of
the five analytic ``benchmarks/torch_*.py`` scripts gives the payload of
its ``bench_*`` counterpart, and writes it under its own ``torch_`` name.
"""
import dataclasses
import importlib
import inspect
import itertools
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from repro.perfmodel import atleus as j_atleus  # noqa: E402
from repro_torch.perfmodel import atleus as t_atleus  # noqa: E402

MODULES = ("atleus", "baselines", "cost", "noc", "pipeline")
PAPER = {   # benchmarks.common.PAPER_MODELS
    "roberta-base": dict(n_layers=12, d_model=768, n=512),
    "bert-large": dict(n_layers=24, d_model=1024, n=512),
    "gpt2-medium": dict(n_layers=24, d_model=1024, n=1024),
    "bloom-560m": dict(n_layers=24, d_model=1024, n=2048),
}
# the systolic grids of Fig. 6, and one odd grid
GRIDS = [(32, 32), (64, 32), (32, 64), (128, 32), (64, 64), (32, 128),
         (128, 64), (256, 16), (100, 7)]


def _mods(name):
    return (importlib.import_module(f"repro.perfmodel.{name}"),
            importlib.import_module(f"repro_torch.perfmodel.{name}"))


def _dims(side, **kw):
    """TransformerDims of each paper model (and two variants: a set d_ff,
    another LoRA rank and count) on one side."""
    mod = j_atleus if side == "jax" else t_atleus
    out = [mod.TransformerDims(n, **d, **kw) for n, d in PAPER.items()]
    out.append(mod.TransformerDims("odd", n_layers=3, d_model=200, n=77,
                                   d_ff=600, lora_r=8, lora_k=4,
                                   weight_bits=8))
    return out


def _plain(x):
    """Results as plain data: dataclasses by their fields, StageDelays with
    its properties."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        d = {f.name: _plain(getattr(x, f.name))
             for f in dataclasses.fields(x)}
        for prop in ("ff", "bottleneck"):
            if hasattr(x, prop):
                d[prop] = getattr(x, prop)
        if hasattr(x, "total"):
            d["total"] = {s: x.total(s) for s in x.compute}
        return d
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _public(mod):
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and not inspect.ismodule(v)
            and getattr(v, "__module__", mod.__name__) == mod.__name__}


def _calls(module, fn):
    """(args, kwargs) grids per function: each callable gets the dims and
    arguments the figure scripts pass, and more."""
    dims_j, dims_t = _dims("jax"), _dims("torch")
    shapes = [(d.d_model, 4 * d.d_model, d.n) for d in dims_j[:4]] + [
        (d.ff, d.d_model, d.n) for d in dims_j[:4]] + [(200, 600, 77)]
    g = {}
    if module == "atleus":
        dims_fns = {"mm_reram_ops": [{}], "mm_systolic_ops":
                    [{}, {"fine_tuning": False}],
                    "reram_share": [{}, {"fine_tuning": False}]}
        if fn in dims_fns:
            return [((dj,), (dt,), kw) for dj, dt in zip(dims_j, dims_t)
                    for kw in dims_fns[fn]]
        if fn == "reram_matmul_time":
            g = [((r, c, n), dict(weight_bits=wb, input_bits=ib, cores=co,
                                  layers_resident=lr, dequant=dq))
                 for (r, c, n) in shapes
                 for wb, ib, co, lr, dq in itertools.product(
                     (4, 8, 16), (4, 8), (1, 16), (1, 12, 24), (False, True))]
        elif fn == "reram_matmul_energy":
            g = [((r, c, n), dict(weight_bits=wb)) for (r, c, n) in shapes
                 for wb in (2, 4, 8, 16)]
        elif fn in ("systolic_matmul_time", "systolic_utilization"):
            mkn = [(n, d, n) for d, _, n in shapes[:4]] + [
                (n, d, 32) for d, _, n in shapes[:4]] + [(77, 200, 8)]
            g = [((m, k, n2, r, c) if fn == "systolic_utilization"
                  else (m, k, n2),
                  dict(cores=co, dataflow=df) if fn == "systolic_utilization"
                  else dict(rows=r, cols=c, cores=co, dataflow=df))
                 for (m, k, n2) in mkn for (r, c) in GRIDS
                 for co in (1, 16) for df in ("OS", "WS", "IS")]
        elif fn == "systolic_matmul_energy":
            g = [((n, d, n), {}) for d, _, n in shapes] + [((7, 8, 9), {})]
        elif fn == "softmax_time":
            g = [((n, n), {}) for _, _, n in shapes]
        elif fn in ("hbm_time", "hbm_energy"):
            g = [((b,), {}) for b in (0.0, 1.0, 3.5e6, 2.0 * 1024 * 32 * 4)]
        elif fn == "TransformerDims":
            return [((n,), (n,), dict(**d, d_ff=ff, lora_r=r))
                    for n, d in PAPER.items() for ff in (None, 3000)
                    for r in (8, 32)]
    elif module == "pipeline":
        bits = [(16, 16), (8, 8), (8, 4), (4, 8), (4, 4)]
        if fn == "atleus_stages":
            return [((dj,), (dt,), dict(fine_tuning=ft, mha_bits=m,
                                        ff_bits=f))
                    for dj, dt in zip(dims_j, dims_t) for ft in (True, False)
                    for m, f in bits]
        if fn == "haima_stages":
            return [((dj,), (dt,), dict(fine_tuning=ft, quant_bits=q))
                    for dj, dt in zip(dims_j, dims_t) for ft in (True, False)
                    for q in (16, 8, 4)]
        if fn == "atleus_layer_energy":
            return [((dj,), (dt,), dict(fine_tuning=ft, mha_bits=m,
                                        ff_bits=f))
                    for dj, dt in zip(dims_j, dims_t) for ft in (True, False)
                    for m, f in bits]
        if fn == "end_to_end_time":
            jp, tp = _mods("pipeline")
            return [((jp.atleus_stages(dj), nl, nb),
                     (tp.atleus_stages(dt), nl, nb), {})
                    for dj, dt in zip(dims_j, dims_t) for nl in (1, 24)
                    for nb in (1, 100)]
        if fn == "StageDelays":
            c = {"S1": 1.0, "S2": 3.5, "S3": 2.0, "S4": 0.5}
            return [((c, {k: v / 2 for k, v in c.items()}),) * 2 + ({},)]
    elif module == "baselines":
        if fn in ("atleus_time_energy",):
            return [((dj,), (dt,), dict(n_batches=nb, fine_tuning=ft,
                                        mha_bits=m, ff_bits=f))
                    for dj, dt in zip(dims_j, dims_t) for nb in (1, 100)
                    for ft in (True, False)
                    for m, f in ((16, 16), (8, 8), (8, 4), (4, 8), (4, 4))]
        if fn in ("haima_time_energy", "gpu_time_energy",
                  "tpu3d_time_energy"):
            return [((dj,), (dt,), dict(n_batches=nb, fine_tuning=ft,
                                        quant_bits=q))
                    for dj, dt in zip(dims_j, dims_t) for nb in (1, 100)
                    for ft in (True, False) for q in (16, 8, 4)]
        if fn == "quant_energy_trend":
            return [((dj,), (dt,), {}) for dj, dt in zip(dims_j, dims_t)] + [
                ((dj,), (dt,), dict(configs={"M2F6": (2, 6)}))
                for dj, dt in zip(dims_j, dims_t)]
    elif module == "cost":
        areas = (1.0, 25.0, 100.0, 123.4, 400.0)
        if fn == "n_die":
            g = [((a,), {}) for a in areas] + [((a,), dict(wafer_mm=200.0))
                                               for a in areas]
        elif fn == "die_yield":
            g = [((a,), dict(d0=d0, alpha=al)) for a in areas
                 for d0 in (0.1, 0.2) for al in (1.0, 3.0)]
        elif fn == "die_cost":
            g = [((a,), dict(wafer_cost=w)) for a in areas for w in (1.0, 7.5)]
        elif fn == "cost_3d":
            g = [((tiers,), dict(y_stacking=y)) for tiers in
                 ([100.0] * 4, [50.0, 60.0, 70.0], [400.0])
                 for y in (0.98, 0.9)]
        elif fn == "normalized_die_cost":
            g = [((a, b), {}) for a in areas for b in areas]
        elif fn == "tsv_area_mm2":
            g = [((n, dia), {}) for n in (0, 16, 1000) for dia in (5.0, 15.0)]
        elif fn == "compare_2d_vs_3d":
            g = [((), {}), ((), dict(tier_mm2=50.0, n_tiers=3))]
    elif module == "noc":
        cfgs = ("mesh", "mesh_skip", "atleus")
        if fn in ("router_ports", "port_histogram", "edp", "noc_area",
                  "tier_area"):
            g = [((c,), {}) for c in cfgs]
        elif fn == "compare":
            g = [((), {})]
    return [(a, a, kw) for a, kw in g]


def _callables(module):
    jm, _ = _mods(module)
    return sorted(n for n in _public(jm) if callable(getattr(jm, n))
                  and not isinstance(getattr(jm, n), dict))


CALLABLES = [(m, f) for m in MODULES for f in _callables(m)]


@pytest.mark.parametrize("module", MODULES)
def test_module_has_the_same_public_names_and_constants(module):
    jm, tm = _mods(module)
    assert _public(jm) == _public(tm)
    for name in _public(jm):
        jv = getattr(jm, name)
        if callable(jv) and not isinstance(jv, dict):
            continue
        tv = getattr(tm, name)
        if isinstance(jv, dict) and all(callable(v) for v in jv.values()):
            # BASELINES: name -> function of the same name
            assert {k: v.__name__ for k, v in jv.items()} == \
                {k: v.__name__ for k, v in tv.items()}
        else:
            assert jv == tv and type(jv) is type(tv), name


@pytest.mark.parametrize("module,fn", CALLABLES)
def test_function_returns_jax_numbers_exactly(module, fn):
    jm, tm = _mods(module)
    calls = _calls(module, fn)
    assert calls, f"no argument grid for {module}.{fn}"
    for ja, ta, kw in calls:
        want = _plain(getattr(jm, fn)(*ja, **kw))
        got = _plain(getattr(tm, fn)(*ta, **kw))
        assert got == want, (fn, ja, kw)


FIGURES = [("systolic_config", "fig6_systolic_grid"),
           ("noc", "fig8_noc"),
           ("pipeline_stages", "fig10_pipeline_stages"),
           ("end2end", "fig11_15_end2end"),
           ("quant_energy", "fig12_14_quant_energy")]


@pytest.mark.parametrize("bench,out", FIGURES)
def test_figure_script_payload_equals_jax_script(bench, out, tmp_path,
                                                 monkeypatch):
    common = importlib.import_module("benchmarks.common")
    assert common.PAPER_MODELS == PAPER
    monkeypatch.setattr(common, "OUT", tmp_path)
    jb = importlib.import_module(f"benchmarks.bench_{bench}")
    tb = importlib.import_module(f"benchmarks.torch_{bench}")
    want, got = jb.run(), tb.run()
    assert got == want
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [f"{out}.json", f"torch_{out}.json"])
    assert (json.loads((tmp_path / f"torch_{out}.json").read_text())
            == json.loads((tmp_path / f"{out}.json").read_text()))
