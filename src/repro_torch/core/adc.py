"""Column ADC energy model (paper SSV-C, eq. 26, after Murmann [48]):

    E_ADC = k1 (B_ADC + log2(V_DD / V_c)) + k2 (V_DD / V_c)^2 4^B_ADC

with k1 = 100 fJ (per-bit/logic term) and k2 = 1 aJ (noise-limited comparator
term).  ``V_c`` is the voltage range being quantized: a small V_c forces the ADC
into the noise-limited regime and the second term explodes as 4^B_ADC.
"""
from __future__ import annotations

import math

from repro_torch.core.compute_models import TECH_65NM, TechParams

K1 = 100e-15  # J
K2 = 1e-18  # J


def adc_energy(
    b_adc: int,
    vdd_over_vc: float,
    tech: TechParams = TECH_65NM,
    k1: float = K1,
    k2: float = K2,
) -> float:
    """Eq. (26). ``vdd_over_vc`` = V_DD / V_c >= 1 typically."""
    r = max(vdd_over_vc, 1.0)
    return k1 * (b_adc + math.log2(r)) + k2 * r * r * 4.0**b_adc


def adc_delay(b_adc: int, tech: TechParams = TECH_65NM) -> float:
    """SAR conversion time: B_ADC bit-cycles."""
    return b_adc * tech.t_adc_per_bit
