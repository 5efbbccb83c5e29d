"""Paper Fig. 10: per-stage compute+comm delays, Atleus vs HAIMA
(BERT-Large, n=512) + quantized-stage speedup (SS IV.D duplication).

The port's copy of ``benchmarks/bench_pipeline_stages.py`` on ``repro_torch.perfmodel``
(standard library only; no card needed):

    PYTHONPATH=src:. python benchmarks/torch_pipeline_stages.py

It writes ``experiments/paper/torch_fig10_pipeline_stages.json`` beside the JAX
script's ``fig10_pipeline_stages.json``."""
from benchmarks.torch_common import PAPER_MODELS, emit, save_json
from repro_torch.perfmodel import pipeline as pipe
from repro_torch.perfmodel.atleus import TransformerDims


def run():
    d = TransformerDims("bert-large", **PAPER_MODELS["bert-large"])
    at = pipe.atleus_stages(d)
    ha = pipe.haima_stages(d)
    at8 = pipe.atleus_stages(d, mha_bits=8, ff_bits=8)
    payload = {}
    for s in ("S1", "S2", "S3", "S4"):
        payload[s] = {
            "atleus_compute_us": at.compute[s] * 1e6,
            "atleus_comm_us": at.comm[s] * 1e6,
            "haima_compute_us": ha.compute[s] * 1e6,
            "haima_comm_us": ha.comm[s] * 1e6,
            "atleus_m8f8_us": at8.total(s) * 1e6,
        }
        emit(f"fig10_{s}", 0.0,
             f"atleus={at.total(s)*1e6:.0f}us_haima={ha.total(s)*1e6:.0f}us")
    payload["bottleneck_ratio_haima_over_atleus"] = ha.bottleneck / at.bottleneck
    payload["quantized_bottleneck_speedup"] = at.bottleneck / at8.bottleneck
    emit("fig10_bottleneck", 0.0,
         f"haima/atleus={ha.bottleneck/at.bottleneck:.1f}x_m8f8_speedup="
         f"{at.bottleneck/at8.bottleneck:.2f}x")
    save_json("torch_fig10_pipeline_stages", payload)
    return payload


if __name__ == "__main__":
    run()
