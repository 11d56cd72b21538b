"""Mapping matmuls onto IMC bit-cell arrays: bank tiling, and whole-model
energy/delay/SNR rollups (beyond-paper extension of SSV-C to full architectures).

A (K x M) weight matrix deployed on R-row x C-col SRAM banks occupies
ceil(K/R) x ceil(M*B_w/C) banks (QS-Arch stores B_w columns per output).  A
T-token forward pass executes T dot products per output column; banks operate in
parallel, K-direction partials reduce digitally.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.compute_models import TECH_65NM, TechParams
from repro_torch.core.design import DesignPoint, optimize
from repro_torch.core.quant import SignalStats, UNIFORM_STATS


@dataclasses.dataclass(frozen=True)
class BankSpec:
    rows: int = 512  # paper SSV: 512-row SRAM array
    cols: int = 512


@dataclasses.dataclass(frozen=True)
class MatmulShape:
    """One linear layer: y[M] = W[K, M]^T x[K], executed for `calls` tokens."""

    name: str
    k: int
    m: int
    calls: int = 1


def per_token_matmul_shapes(cfg) -> List[MatmulShape]:
    """All weight-stationary matmul sites one token-forward of ``cfg``
    executes (attention score/value products are activation-activation and
    stay digital).  ``calls`` counts layer repetitions per token.

    This is THE shapes walk: model-scale energy rollups
    (``benchmarks/model_energy``), the serve-path meter
    (``launch.metering.DPMeter``) and the profiling-side rollup
    (``launch.breakdown``) all share it, so a site can never be counted
    twice (or with diverging ``calls``) between the accounting paths.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes: List[MatmulShape] = []
    counts: Dict[str, int] = {}
    for kind in cfg.pattern:
        counts[kind] = counts.get(kind, 0) + cfg.n_full_cycles
    for kind in cfg.tail_kinds:
        counts[kind] = counts.get(kind, 0) + 1
    for kind, cnt in counts.items():
        if kind in ("attn", "local"):
            shapes += [
                MatmulShape(f"{kind}.wq", d, cfg.n_heads * hd, cnt),
                MatmulShape(f"{kind}.wk", d, cfg.n_kv_heads * hd, cnt),
                MatmulShape(f"{kind}.wv", d, cfg.n_kv_heads * hd, cnt),
                MatmulShape(f"{kind}.wo", cfg.n_heads * hd, d, cnt),
            ]
        elif kind == "ssm":
            d_in = cfg.ssm_expand * d
            proj = (2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state
                    + d_in // cfg.ssm_head_dim)
            shapes += [
                MatmulShape("ssm.in_proj", d, proj, cnt),
                MatmulShape("ssm.out_proj", d_in, d, cnt),
            ]
        elif kind == "rglru":
            w = cfg.rnn_width
            shapes += [
                MatmulShape("rg.x", d, w, cnt),
                MatmulShape("rg.gate", d, w, cnt),
                MatmulShape("rg.out", w, d, cnt),
            ]
        if kind != "ssm" and cfg.d_ff > 0:
            mults = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
            e = cfg.top_k if cfg.n_experts else 1  # active experts per token
            shapes += [
                MatmulShape("mlp.wi", d, cfg.d_ff, cnt * e * (mults - 1)),
                MatmulShape("mlp.wo", cfg.d_ff, d, cnt * e),
            ]
    shapes.append(MatmulShape("lm_head", d, cfg.vocab_size, 1))
    return shapes


@dataclasses.dataclass(frozen=True)
class LayerReport:
    name: str
    k: int
    m: int
    calls: int
    n_banks_k: int
    n_banks_m: int
    design: DesignPoint
    energy_j: float
    delay_s: float
    snr_t_db: float

    @property
    def energy_per_mac_j(self) -> float:
        return self.energy_j / (self.k * self.m * self.calls)


def map_matmul(
    shape: MatmulShape,
    snr_t_target_db: float,
    bank: BankSpec = BankSpec(),
    stats: SignalStats = UNIFORM_STATS,
    tech: TechParams = TECH_65NM,
    kinds=("qs", "qr", "cm"),
    design: Optional[DesignPoint] = None,
) -> Optional[LayerReport]:
    """Tile one matmul onto banks and cost it at the optimal design point.

    The DP dimension per bank is min(K, rows); K-direction tiling reduces
    digitally (handled inside `optimize` via its banking dimension when
    K <= rows*max_banks, otherwise we tile explicitly here).
    """
    n_banks_k = int(math.ceil(shape.k / bank.rows))
    n_bank_rows = int(math.ceil(shape.k / n_banks_k))
    if design is None:
        design = optimize(
            n=shape.k,
            snr_t_target_db=snr_t_target_db,
            stats=stats,
            tech=tech,
            kinds=kinds,
            max_rows=bank.rows,
        )
    if design is None:
        return None
    arch = design.arch(stats)
    bw = design.bw
    cols_per_out = bw if design.arch_kind == "qs" else 1
    n_banks_m = int(math.ceil(shape.m * cols_per_out / bank.cols))

    # per-DP energy already includes the K-direction bank reduction (design.n_banks)
    e_dp = design.energy_per_dp
    energy = e_dp * shape.m * shape.calls
    # all M columns within a bank convert in column-parallel; bank-tiles in M are
    # independent banks (parallel); K-direction reduction is in the design point.
    delay = design.delay_per_dp * shape.calls
    return LayerReport(
        name=shape.name,
        k=shape.k,
        m=shape.m,
        calls=shape.calls,
        n_banks_k=design.n_banks,
        n_banks_m=n_banks_m,
        design=design,
        energy_j=energy,
        delay_s=delay,
        snr_t_db=design.snr_t_db,
    )


@dataclasses.dataclass
class ModelReport:
    layers: List[LayerReport]

    @property
    def total_energy_j(self) -> float:
        return sum(l.energy_j for l in self.layers)

    @property
    def total_macs(self) -> int:
        return sum(l.k * l.m * l.calls for l in self.layers)

    @property
    def energy_per_mac_j(self) -> float:
        return self.total_energy_j / max(self.total_macs, 1)

    @property
    def tops_per_watt(self) -> float:
        """2 ops per MAC."""
        return 2.0 / self.energy_per_mac_j / 1e12

    @property
    def min_snr_t_db(self) -> float:
        return min(l.snr_t_db for l in self.layers)

    def summary(self) -> Dict[str, float]:
        return {
            "layers": len(self.layers),
            "total_energy_j": self.total_energy_j,
            "energy_per_mac_fj": self.energy_per_mac_j * 1e15,
            "tops_per_watt": self.tops_per_watt,
            "min_snr_t_db": self.min_snr_t_db,
        }


def map_model(
    shapes: List[MatmulShape],
    snr_t_target_db: float,
    bank: BankSpec = BankSpec(),
    stats: SignalStats = UNIFORM_STATS,
    tech: TechParams = TECH_65NM,
    kinds=("qs", "qr", "cm"),
) -> ModelReport:
    """Cost a whole model (list of matmul shapes) on IMC hardware.

    Design points are cached per distinct K (the optimizer only depends on the
    DP dimension), so 60-layer models cost ~3 optimizer calls.
    """
    cache: Dict[int, Optional[DesignPoint]] = {}
    reports = []
    for s in shapes:
        if s.k not in cache:
            cache[s.k] = optimize(
                n=s.k, snr_t_target_db=snr_t_target_db, stats=stats, tech=tech,
                kinds=kinds, max_rows=bank.rows,
            )
        d = cache[s.k]
        r = map_matmul(s, snr_t_target_db, bank, stats, tech, kinds, design=d)
        if r is not None:
            reports.append(r)
    return ModelReport(layers=reports)
