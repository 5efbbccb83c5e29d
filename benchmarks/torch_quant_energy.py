"""Paper Figs. 12 & 14: system energy under MnFm quantization, normalized
to each architecture's 16-bit implementation. Atleus decreases (slope < 1);
GPU / 3D-TPU / HAIMA increase (dequantize-before-compute).

The port's copy of ``benchmarks/bench_quant_energy.py`` on ``repro_torch.perfmodel``
(standard library only; no card needed):

    PYTHONPATH=src:. python benchmarks/torch_quant_energy.py

It writes ``experiments/paper/torch_fig12_14_quant_energy.json`` beside the JAX
script's ``fig12_14_quant_energy.json``."""
from benchmarks.torch_common import PAPER_MODELS, emit, save_json
from repro_torch.perfmodel import baselines as bl
from repro_torch.perfmodel.atleus import TransformerDims


def run():
    payload = {}
    for name in ("gpt2-medium", "bloom-560m"):
        d = TransformerDims(name, **PAPER_MODELS[name])
        tr = bl.quant_energy_trend(d)
        payload[name] = tr
        for tag, row in tr.items():
            emit(f"quant_energy_{name}_{tag}", 0.0,
                 "_".join(f"{k}={v:.2f}" for k, v in row.items()))
        # paper invariants
        assert tr["M8F4"]["atleus"] < tr["M4F8"]["atleus"], \
            "FF quantization must save more than MHA (2x params)"
        assert all(tr[t]["gpu"] > 1.0 for t in tr if t != "M16F16")
        assert all(tr[t]["atleus"] < 1.0 for t in tr if t != "M16F16")
    save_json("torch_fig12_14_quant_energy", payload)
    return payload


if __name__ == "__main__":
    run()
