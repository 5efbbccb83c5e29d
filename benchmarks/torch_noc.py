"""Paper Fig. 8(a/b) + SS V.D: NoC port histograms, EDP/area/cost, and the
2D-vs-3D die-cost comparison.

The port's copy of ``benchmarks/bench_noc.py`` on ``repro_torch.perfmodel``
(standard library only; no card needed):

    PYTHONPATH=src:. python benchmarks/torch_noc.py

It writes ``experiments/paper/torch_fig8_noc.json`` beside the JAX
script's ``fig8_noc.json``."""
from benchmarks.torch_common import emit, save_json
from repro_torch.perfmodel import cost as cost_mod
from repro_torch.perfmodel.noc import compare


def run():
    c = compare()
    for cfgname, row in c.items():
        emit(f"noc_{cfgname}", 0.0,
             f"edp={row['edp']:.3f}_area={row['noc_area']:.3f}_cost={row['cost']:.4f}")
    c3, c2, ratio = cost_mod.compare_2d_vs_3d()
    emit("cost_2d_vs_3d", 0.0, f"2d/3d={ratio:.2f}_paper=1.67")
    payload = {"noc": c, "cost_2d_vs_3d": {"3d": c3, "2d": c2, "ratio": ratio},
               "paper_targets": {"mesh_skip": {"edp": 0.88, "area": 1.16},
                                 "atleus": {"edp": 0.73, "area": 1.04},
                                 "2d_over_3d": 1.67}}
    save_json("torch_fig8_noc", payload)
    return payload


if __name__ == "__main__":
    run()
