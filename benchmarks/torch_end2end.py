"""Paper Figs. 11 & 15: normalized fine-tuning and inference execution
time/energy vs HAIMA / 3D-TPU / GPU (Atleus = 1).

The port's copy of ``benchmarks/bench_end2end.py`` on ``repro_torch.perfmodel``
(standard library only; no card needed):

    PYTHONPATH=src:. python benchmarks/torch_end2end.py

It writes ``experiments/paper/torch_fig11_15_end2end.json`` beside the JAX
script's ``fig11_15_end2end.json``."""
from benchmarks.common import PAPER_MODELS, emit, save_json
from repro_torch.perfmodel import baselines as bl
from repro_torch.perfmodel.atleus import TransformerDims


def run():
    payload = {}
    for mode, ft in (("finetune", True), ("inference", False)):
        payload[mode] = {}
        for name in ("roberta-base", "bert-large"):
            d = TransformerDims(name, **PAPER_MODELS[name])
            a = bl.atleus_time_energy(d, n_batches=100, fine_tuning=ft)
            row = {}
            for sysname, fn in bl.BASELINES.items():
                r = fn(d, n_batches=100, fine_tuning=ft)
                row[sysname] = {"time_x": r["time"] / a["time"],
                                "energy_x": r["energy"] / a["energy"]}
            payload[mode][name] = row
            emit(f"fig{'11' if ft else '15'}_{name}", 0.0,
                 "_".join(f"{k}={v['time_x']:.1f}x" for k, v in row.items()))
    payload["paper_claims"] = {"max_speedup_vs_sota": 56.0,
                               "max_energy_vs_sota": 64.5,
                               "tpu_vs_gpu": 2.0}
    save_json("torch_fig11_15_end2end", payload)
    return payload


if __name__ == "__main__":
    run()
