"""Paper Fig. 7 + Eq. 5 + Table II on the port: ReRAM vs systolic compute
and energy breakdown, analytic (``repro_torch.perfmodel``) and tallied from
``repro_torch``'s forward of reduced ``paper-gpt2-medium`` as it runs.

    PYTHONPATH=src:. python benchmarks/torch_compute_breakdown.py [--device cpu]

Runs on the CUDA card by default and on the CPU given ``--device cpu``.
The port's ``hetero.breakdown_of`` runs the forward (train mode, as the
JAX script's) and counts every layer of it; the JAX script
(``benchmarks/bench_compute_breakdown.py``) traces a ``lax.scan`` over
the layers, whose body its tally counts once. Writes
``experiments/paper/torch_fig7_compute_breakdown.json``.
"""
import argparse

import torch

from benchmarks.torch_common import PAPER_MODELS, emit, save_json
from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import hetero, lora as lora_lib
from repro_torch.models import transformer as tfm
from repro_torch.perfmodel import pipeline as pipe
from repro_torch.perfmodel.atleus import TransformerDims, reram_share


def run(device=None):
    dev = resolve_device(device)
    payload = {}
    # --- analytic Eq. 5 across the paper's models ---
    for name, dims in PAPER_MODELS.items():
        d = TransformerDims(name, **dims)
        share = reram_share(d)
        e = pipe.atleus_layer_energy(d)
        payload[name] = {
            "reram_share_pct": share * 100,
            "ratio": share / (1 - share),
            "ratio_12d_over_n": 12 * d.d_model / d.n,
            "energy_reram_pct": 100 * e["reram"] / (e["reram"] + e["systolic"]),
        }
        emit(f"eq5_share_{name}", 0.0,
             f"reram={share*100:.1f}%_paper=90.1-94.7%")

    # --- tallied from the real model (GPT-2M shaped, reduced depth) ---
    cfg = reduce_config(get_config("paper-gpt2-medium"), n_periods=2,
                        d_model=256, n_heads=8, d_ff=1024)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    lora = lora_lib.init_lora_params(
        cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    toks = {"tokens": torch.zeros((1, 256), dtype=torch.int32, device=dev)}

    def fwd(p, l):
        return tfm.forward(cfg, p, toks, lora=l, mode="train")[0]

    rep = hetero.breakdown_of(fwd, params, lora)
    payload["traced_gpt2m_reduced"] = {
        "static_share_pct": rep.static_share * 100,
        "static_flops": rep.static_flops,
        "dynamic_flops": rep.dynamic_flops,
    }
    payload["device"] = str(dev)
    emit("traced_static_share", 0.0,
         f"static={rep.static_share*100:.1f}%_dynamic={100-rep.static_share*100:.1f}%")
    save_json("torch_fig7_compute_breakdown", payload)
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    run(ap.parse_args().device)
