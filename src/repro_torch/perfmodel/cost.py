"""Die-yield and 3D-stack cost model (paper Eqs. 6-11, SS V.D).

Pure math — no calibration: N_die from wafer geometry, Bose-Einstein-style
clustered-defect yield, 3D stacking yield, TSV keep-out area.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# paper-stated physical parameters [SS V.D]
D0 = 0.2          # defects / cm^2
ALPHA = 3.0       # clustering
WAFER_MM = 300.0  # wafer diameter (the paper's "300nm" is a typo for mm)
Y_WAFER = 1.0
Y_STACKING = 0.98
Y_TSV = 0.99
TSV_PITCH_FACTOR = 3.0  # pitch = 3 * diameter [52]


def n_die(area_mm2: float, wafer_mm: float = WAFER_MM) -> float:
    """Eq. 7."""
    r = wafer_mm / 2.0
    return (math.pi * r * r / area_mm2
            - math.pi * wafer_mm / math.sqrt(2.0 * area_mm2))


def die_yield(area_mm2: float, d0: float = D0, alpha: float = ALPHA) -> float:
    """Eq. 8 (D0 per cm^2 -> area in cm^2)."""
    a_cm2 = area_mm2 / 100.0
    return Y_WAFER * (1.0 + a_cm2 * d0 / alpha) ** (-alpha)


def die_cost(area_mm2: float, wafer_cost: float = 1.0) -> float:
    """Eq. 6 (relative units)."""
    return (wafer_cost / n_die(area_mm2)) / die_yield(area_mm2)


def cost_3d(tier_areas_mm2, y_stacking: float = Y_STACKING,
            y_tsv: float = Y_TSV) -> float:
    """Eq. 9."""
    n = len(tier_areas_mm2)
    return sum(die_cost(a) for a in tier_areas_mm2) / (
        y_stacking ** (n - 1) * y_tsv)


def normalized_die_cost(area_a: float, area_b: float) -> float:
    """Eq. 10: cost(A) relative to cost(B)."""
    return (die_yield(area_b) * n_die(area_b)) / (
        die_yield(area_a) * n_die(area_a))


def tsv_area_mm2(n_tsv: int, diameter_um: float) -> float:
    """Eq. 11 third term: keep-out = pitch^2 per TSV."""
    pitch_mm = TSV_PITCH_FACTOR * diameter_um * 1e-3
    return n_tsv * pitch_mm * pitch_mm


def compare_2d_vs_3d(tier_mm2: float = 100.0, n_tiers: int = 4):
    """SS V.D: four 100 mm^2 tiers vs one 400 mm^2 2D die.

    Returns (cost_3d, cost_2d, ratio). The paper reports the 2D die cost
    ~67% higher than the summed 3D tier cost."""
    c3d = cost_3d([tier_mm2] * n_tiers)
    c2d = die_cost(tier_mm2 * n_tiers)
    return c3d, c2d, c2d / c3d
