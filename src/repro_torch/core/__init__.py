"""repro_torch.core - the paper's IMC analytics and the IMC layer.

  quant           additive quantization noise model, uniform quantizers, PARs
  snr             compute SNR metrics + composition rules (eqs. 6-11)
  precision       BGC / tBGC / MPC output-precision criteria (eqs. 12-15)
  compute_models  QS / IS / QR physical compute models (eqs. 16-25, Table II)
  archs           QS-Arch / QR-Arch / CM architecture analytics (Table III)
  adc             column-ADC energy model (eq. 26)
  scaling         technology-node parameter tables (SSV-D)
  mc              sample-accurate Monte Carlo validators (SSV-A, Fig. 8): a
                  draw step per simulator on an explicit torch.Generator, a
                  deterministic chain, and chunked ensemble runs
  design          min-energy design-point solver (SSVI guidelines as a solver)
  mapping         matmul -> bank tiling + whole-model energy rollups
  imc_linear      the executable IMC linear layer (digital/fakequant/analytic/bitserial)
  substrate       execution substrates: per-site design points,
                  frozen-vs-dynamic calibration, batch-invariant IMC serving
"""
from repro_torch.core.adc import adc_energy  # noqa: F401
from repro_torch.core.archs import CMArch, IMCArch, QRArch, QSArch  # noqa: F401
from repro_torch.core.compute_models import (  # noqa: F401
    ISModel,
    QRModel,
    QSModel,
    TECH_65NM,
    TechParams,
)
from repro_torch.core.design import DesignPoint, optimize, pareto_sweep  # noqa: F401
from repro_torch.core.mapping import (  # noqa: F401
    BankSpec,
    MatmulShape,
    ModelReport,
    map_matmul,
    map_model,
)
from repro_torch.core.precision import (  # noqa: F401
    PrecisionAssignment,
    assign_precisions,
    by_bgc,
    by_mpc_lower_bound,
    gaussian_clip_stats,
    optimal_zeta,
    sqnr_qy_bgc_db,
    sqnr_qy_fullrange,
    sqnr_qy_mpc,
    sqnr_qy_mpc_db,
)
from repro_torch.core.quant import (  # noqa: F401
    QuantSpec,
    SignalStats,
    UNIFORM_STATS,
    bit_planes,
    combine_bit_planes,
    db,
    dequantize,
    fakequant,
    quantize,
    sqnr_qiy,
    sqnr_qiy_db_approx,
    undb,
)
from repro_torch.core.snr import compose_snr, compose_snr_db, empirical_snr_db  # noqa: F401
from repro_torch.core.substrate import (  # noqa: F401
    AnalyticIMC,
    BitSerialIMC,
    Calibration,
    CalibrationRecorder,
    DigitalSubstrate,
    SiteStats,
    Substrate,
    as_substrate,
    calibrate_model,
    substrate_for_design,
    substrate_ladder,
)
