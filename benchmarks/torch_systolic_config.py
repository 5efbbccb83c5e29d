"""Paper Fig. 6: systolic grid search — PE count & aspect ratio vs the
ReRAM pipeline-stage delay; 4096 PEs at 128x32 should win.

The port's copy of ``benchmarks/bench_systolic_config.py`` on ``repro_torch.perfmodel``
(standard library only; no card needed):

    PYTHONPATH=src:. python benchmarks/torch_systolic_config.py

It writes ``experiments/paper/torch_fig6_systolic_grid.json`` beside the JAX
script's ``fig6_systolic_grid.json``."""
from benchmarks.torch_common import PAPER_MODELS, emit, save_json
from repro_torch.perfmodel import atleus as hw, pipeline as pipe
from repro_torch.perfmodel.atleus import TransformerDims

GRIDS = [(32, 32), (64, 32), (32, 64), (128, 32), (64, 64), (32, 128),
         (128, 64), (256, 16)]


def run():
    payload = {}
    for name in ("bert-large", "gpt2-medium"):
        d = TransformerDims(name, **PAPER_MODELS[name])
        # reference: the slowest ReRAM stage at the paper's M8F8 deployment
        reram_stage = max(
            hw.reram_matmul_time(d.d_model, 4 * d.d_model, d.n, weight_bits=8,
                                 cores=16, layers_resident=d.n_layers,
                                 dequant=True),
            hw.reram_matmul_time(d.ff, d.d_model, d.n, weight_bits=8,
                                 cores=16, layers_resident=d.n_layers,
                                 dequant=True))
        rows = {}
        for (r, c) in GRIDS:
            # fine-tuning: attention fwd + backward (2 more matmuls each)
            t = 3 * (hw.systolic_matmul_time(d.n, d.d_model, d.n, rows=r,
                                             cols=c, cores=16)
                     + hw.systolic_matmul_time(d.n, d.n, d.d_model, rows=r,
                                               cols=c, cores=16))
            t += hw.softmax_time(d.n, d.n)
            for _ in range(d.lora_k):   # LoRA A (n,d,r) and B (n,r,d)
                t += 2 * (hw.systolic_matmul_time(d.n, d.d_model, d.lora_r,
                                                  rows=r, cols=c, cores=16)
                          + hw.systolic_matmul_time(d.n, d.lora_r, d.d_model,
                                                    rows=r, cols=c, cores=16))
            util = hw.systolic_utilization(d.n, d.d_model, d.lora_r, r, c)
            rows[f"{r}x{c}"] = {"pes": r * c,
                                "delay_norm": t / reram_stage,
                                "lora_util": util}
        payload[name] = rows
        # the paper's finding: <4096 PEs can't fit in one stage; among the
        # 4096-PE shapes our analytical model puts 128x32 and 64x64 within
        # ~6% (SCALE-sim's finer pipeline modeling selects 128x32).
        fits = sorted((g for g, v in rows.items() if v["delay_norm"] <= 1.0),
                      key=lambda g: rows[g]["pes"])
        min_pes = rows[fits[0]]["pes"] if fits else None
        payload[name + "__finding"] = {
            "min_pes_fitting": min_pes,
            "fits_128x32": "128x32" in fits,
            "smaller_grids_fail": all(rows[g]["delay_norm"] > 1.0
                                      for g in rows if rows[g]["pes"] < 4096),
        }
        emit(f"systolic_{name}", 0.0,
             f"min_fitting_pes={min_pes}_128x32_fits={'128x32' in fits}"
             f"_delay128x32={rows['128x32']['delay_norm']:.2f}")
    save_json("torch_fig6_systolic_grid", payload)
    return payload


if __name__ == "__main__":
    run()
