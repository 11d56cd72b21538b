"""Technology-node parameter tables for the scaling study (paper SSV-D, Fig. 13).

The paper scales the Table II parameters "per the ITRS roadmap [52]" (FDSOI at
22/11/7 nm) without printing the table; we encode a roadmap-shaped table whose
qualitative anchors are asserted in tests:

  * max achievable SNR_A of QS-Arch/CM *decreases* from 65 nm to 7 nm
    (lower V_dd => more headroom clipping; worse sigma_Vt/(V_WL - V_t)),
  * at fixed SNR_A, energy at 11/7 nm is *higher* than at 22 nm for QS-Arch/CM,
  * QR-Arch keeps approaching the quantization limit (no clipping) and gets
    ~4x energy per 6 dB cheaper with scaling.

Trends encoded: V_dd and C scale down; V_t roughly flat (leakage floor);
sigma_Vt *increases* mildly (smaller devices, AVt/sqrt(WL) with W,L shrinking
faster than AVt improves); wiring/BL cap per row shrinks.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.compute_models import TechParams

# name -> TechParams
NODES: dict[str, TechParams] = {}


def _mk(name, **kw) -> TechParams:
    p = dataclasses.replace(TechParams(), name=name, **kw)
    NODES[name] = p
    return p


TECH_65 = _mk("65nm")  # Table II values (defaults)

TECH_45 = _mk(
    "45nm",
    v_dd=0.95,
    v_t=0.38,
    sigma_vt=26e-3,
    c_bl=210e-15,
    dv_bl_max=0.80,
    k_prime=260e-6,
    t0=85e-12,
    wl_cox=0.26e-15,
    pelgrom_kappa=0.072 * 1e-15**0.5,
    e_switch=0.08e-15,
    e_add_per_bit=0.7e-15,
)

TECH_28 = _mk(
    "28nm",
    v_dd=0.90,
    v_t=0.36,
    sigma_vt=28e-3,
    c_bl=160e-15,
    dv_bl_max=0.75,
    k_prime=300e-6,
    t0=70e-12,
    wl_cox=0.20e-15,
    pelgrom_kappa=0.065 * 1e-15**0.5,
    e_switch=0.06e-15,
    e_add_per_bit=0.5e-15,
)

TECH_22 = _mk(
    "22nm",
    v_dd=0.85,
    v_t=0.35,
    sigma_vt=30e-3,
    c_bl=130e-15,
    dv_bl_max=0.70,
    k_prime=330e-6,
    t0=60e-12,
    wl_cox=0.16e-15,
    pelgrom_kappa=0.060 * 1e-15**0.5,
    e_switch=0.045e-15,
    e_add_per_bit=0.4e-15,
)

TECH_11 = _mk(
    "11nm",
    v_dd=0.75,
    v_t=0.33,
    sigma_vt=34e-3,
    c_bl=90e-15,
    dv_bl_max=0.60,
    k_prime=380e-6,
    t0=45e-12,
    wl_cox=0.10e-15,
    pelgrom_kappa=0.052 * 1e-15**0.5,
    e_switch=0.03e-15,
    e_add_per_bit=0.25e-15,
)

TECH_7 = _mk(
    "7nm",
    v_dd=0.70,
    v_t=0.32,
    sigma_vt=38e-3,
    c_bl=65e-15,
    dv_bl_max=0.55,
    k_prime=420e-6,
    t0=35e-12,
    wl_cox=0.07e-15,
    pelgrom_kappa=0.046 * 1e-15**0.5,
    e_switch=0.02e-15,
    e_add_per_bit=0.18e-15,
)

SCALING_SEQUENCE = ["65nm", "45nm", "28nm", "22nm", "11nm", "7nm"]
PAPER_SEQUENCE = ["65nm", "22nm", "11nm", "7nm"]  # nodes shown in Fig. 13


def node(name: str) -> TechParams:
    return NODES[name]
