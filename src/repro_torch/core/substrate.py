"""Execution substrates: WHICH hardware a matmul runs on, HOW its quantizers
are calibrated, and WHAT design point is billed for it.

A :class:`Substrate` carries an ``IMCConfig`` (the knobs the matmuls
consume), a calibration policy - ``"dynamic"`` (per-batch quantizer stats) or
``"frozen"`` (ranges captured once by a calibration pass and stored in a
:class:`Calibration`) - an optional design point for billing, and per-site
overrides.  Frozen substrates make every forward pass batch-composition-
invariant, so the batched serve engine equals sequential execution.

Per-site overrides are keyed by the site names of the shared shapes walk
(``"attn.wq"``, ``"mlp.wi"``, ``"lm_head"``, ...): an override matches a site
exactly, by its group prefix before the dot (``"attn"``), or ``"*"``.

Calibration stats are running maxima (``x_max`` / ``w_max`` max-|value|,
``sigma_yo`` the max per-row output std), so they are invariant to batch
order and zero-row padding, and a :class:`Calibration` round-trips through
JSON in the JAX reference's format.  In PyTorch there is nothing to trace:
the recorder keeps its running maxima as device tensors and reads them once,
and a calibration swap in the engine is a plain attribute update between
decode chunks, so within a chunk every row quantizes against one
calibration.  :func:`shadow_recording` observes live serve traffic for drift
(``runtime.drift``) without changing what executes.

:func:`substrate_for_design` turns a ``core.design`` design point into the
substrate that executes it (QS points run bit-serial planes, QR and CM
points the folded-noise analytic model), and :func:`substrate_ladder` steps
down the EDAP frontier from one for load-adaptive degradation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch.core.design import DesignPoint
from repro_torch.core.imc_linear import IMCConfig

# stats are max-merged, so every field must be monotone under "observe more"
_STAT_FIELDS = ("x_max", "w_max", "sigma_yo")

# merged-over-all-sites fallback entry: sites unseen during calibration (and
# ``site=None`` callers) freeze against it instead of going dynamic
DEFAULT_SITE = "*"


@dataclasses.dataclass(frozen=True)
class SiteStats:
    """Frozen quantizer statistics of one matmul site (plain floats)."""

    x_max: float
    w_max: float
    sigma_yo: float

    def merge(self, other: "SiteStats") -> "SiteStats":
        return SiteStats(*(max(getattr(self, f), getattr(other, f))
                           for f in _STAT_FIELDS))


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-site frozen ranges, sorted by site name."""

    sites: Tuple[Tuple[str, SiteStats], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "sites", tuple(sorted(self.sites)))

    def get(self, site: Optional[str]) -> Optional[SiteStats]:
        """Stats for ``site``, falling back to the ``"*"`` merged entry."""
        d = dict(self.sites)
        if site is not None and site in d:
            return d[site]
        return d.get(DEFAULT_SITE)

    def site_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.sites)

    def merge(self, other: "Calibration") -> "Calibration":
        d: Dict[str, SiteStats] = dict(self.sites)
        for name, st in other.sites:
            d[name] = d[name].merge(st) if name in d else st
        return Calibration(tuple(d.items()))

    def to_dict(self) -> dict:
        return {name: {f: getattr(st, f) for f in _STAT_FIELDS}
                for name, st in self.sites}

    @classmethod
    def from_dict(cls, d: Mapping[str, Mapping[str, float]]) -> "Calibration":
        return cls(tuple(
            (name, SiteStats(**{f: float(v[f]) for f in _STAT_FIELDS}))
            for name, v in d.items()))


class CalibrationRecorder:
    """Accumulates per-site running-max stats during a calibration pass
    (activate with :func:`recording`) or a shadow-sampled serve chunk
    (:func:`shadow_recording`); ``imc_linear.linear`` feeds it.

    Observations stay on their device: each site keeps a float32
    ``(x_max, w_max, sigma_yo)`` running-max tensor, and :meth:`finalize`
    reads them to the host once.  Max commutes with the widening to float64
    and with the ``+ 1e-9``, so the result equals reading every observation
    at once.

    Under a tensor-parallel shard group a rank observes its share of a
    site.  Ranges are max-reducible: each rank keeps the maxima of its own
    operands and :meth:`finalize` max-reduces them over the group, once,
    when the recorder is read.  A row's output std is not: at a column
    site each rank holds part of every output row, so the rows' first and
    second moments (float64, each column counted once) are summed over the
    group in the observation, a device collective with no host copy, and
    every rank takes the same std and max over rows."""

    def __init__(self):
        self._acc: Dict[str, SiteStats] = {}
        self._dev: Dict[str, torch.Tensor] = {}
        self._group = None  # the shard group observed under, if any

    def note(self, site: str, stats: SiteStats):
        prev = self._acc.get(site)
        self._acc[site] = stats if prev is None else prev.merge(stats)

    def observe(self, site: str, x, w, y=None, group=None, cols=None):
        """Record one (x, w) observation of ``site``; ``y`` defaults to
        ``x @ w``.  All-zero rows of ``x`` change no stat.  No host sync.
        ``group`` is the shard group this rank observes under (None: one
        device or a replicated site); ``cols`` (a ``core.parallel.Columns``)
        says that ``y`` holds this rank's output columns of each row."""
        with torch.no_grad():
            if y is None:
                y = torch.matmul(x, w)
            f32 = torch.float32
            y2 = y.detach().reshape(-1, y.shape[-1])
            if cols is None:
                sigma = y2.to(f32).std(dim=-1, unbiased=False).max()
            else:
                yo = y2[:, cols.owned(group.rank, y2.device)].to(
                    torch.float64)
                mom = group.sum(torch.stack([yo.sum(-1), (yo * yo).sum(-1)],
                                            dim=-1))
                mean = mom[:, 0] / cols.total
                var = torch.clamp(mom[:, 1] / cols.total - mean * mean,
                                  min=0.0)
                sigma = torch.sqrt(var).max().to(f32)
            stats = torch.stack([x.detach().abs().max().to(f32),
                                 w.detach().abs().max().to(f32), sigma])
            prev = self._dev.get(site)
            self._dev[site] = (stats if prev is None
                               else torch.maximum(prev, stats))
            if group is not None:
                self._group = group

    def finalize(self) -> Calibration:
        """Per-site entries plus the ``"*"`` merge of every site.  Under a
        shard group every rank of it must call this at the same point: the
        ranks' maxima are max-reduced (one collective for every site)."""
        entries = dict(self._acc)
        names = sorted(self._dev)
        if names:
            t = torch.stack([self._dev[n] for n in names])
            if self._group is not None:
                t = self._group.max(t)
            for site, (x_max, w_max, sigma) in zip(names, t.tolist()):
                st = SiteStats(x_max=x_max + 1e-9, w_max=w_max + 1e-9,
                               sigma_yo=sigma + 1e-9)
                entries[site] = (st if site not in entries
                                 else entries[site].merge(st))
        if entries and DEFAULT_SITE not in entries:
            merged = None
            for st in entries.values():
                merged = st if merged is None else merged.merge(st)
            entries[DEFAULT_SITE] = merged
        return Calibration(tuple(entries.items()))

    def reset(self):
        """Drop the accumulated stats in place (the instance stays the one
        its monitor and engine hold)."""
        self._acc.clear()
        self._dev.clear()


_ACTIVE = threading.local()


def active_recorder() -> Optional[CalibrationRecorder]:
    return getattr(_ACTIVE, "recorder", None)


@contextlib.contextmanager
def recording(recorder: CalibrationRecorder):
    """Route every non-digital ``imc_linear.linear`` call to ``recorder``."""
    prev = active_recorder()
    _ACTIVE.recorder = recorder
    try:
        yield recorder
    finally:
        _ACTIVE.recorder = prev


def active_shadow_recorder() -> Optional[CalibrationRecorder]:
    return getattr(_ACTIVE, "shadow", None)


@contextlib.contextmanager
def shadow_recording(recorder: CalibrationRecorder):
    """Passively observe every non-digital ``imc_linear.linear`` call into
    ``recorder`` WITHOUT changing execution.

    Unlike :func:`recording` (which runs the calibration-pass fakequant
    proxy in place of the real substrate path), a shadow-observed forward
    runs its real substrate path unchanged - same ops, bit-identical outputs
    - and only adds the recorder's running-max reductions on the device.
    This is what lets the serve engine sample live traffic for drift
    detection (``runtime.drift``) without breaking the frozen-policy
    batch-invariance contract."""
    prev = active_shadow_recorder()
    _ACTIVE.shadow = recorder
    try:
        yield recorder
    finally:
        _ACTIVE.shadow = prev


# ---------------------------------------------------------------------------
# per-site overrides
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SiteOverride:
    """Per-site deviation from a substrate's base assignment: IMCConfig field
    replacements (a sorted tuple) and/or a different billed design point."""

    imc_fields: Tuple[Tuple[str, Any], ...] = ()
    design: Optional[DesignPoint] = None


def _normalize_overrides(overrides) -> Tuple[Tuple[str, SiteOverride], ...]:
    if overrides is None:
        return ()
    if isinstance(overrides, tuple):  # already normalized
        return overrides
    out: List[Tuple[str, SiteOverride]] = []
    for key, val in overrides.items():
        if isinstance(val, SiteOverride):
            out.append((key, val))
            continue
        if isinstance(val, DesignPoint):
            out.append((key, SiteOverride(design=val)))
            continue
        fields = dict(val)
        design = fields.pop("design", None)
        out.append((key, SiteOverride(tuple(sorted(fields.items())), design)))
    return tuple(sorted(out, key=lambda kv: kv[0]))


# ---------------------------------------------------------------------------
# the substrate hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Substrate:
    """One fully specified way to execute (and bill) the model's matmuls.
    Hashable and immutable; prefer the concrete subclasses."""

    imc: IMCConfig = IMCConfig()
    policy: str = "dynamic"  # "dynamic" | "frozen"
    calibration: Optional[Calibration] = None
    design: Optional[DesignPoint] = None
    overrides: Tuple[Tuple[str, SiteOverride], ...] = ()

    def __post_init__(self):
        if self.policy not in ("dynamic", "frozen"):
            raise ValueError(f"unknown calibration policy {self.policy!r}")
        if self.policy == "frozen" and self.calibration is None:
            raise ValueError("a frozen substrate needs a Calibration "
                             "(run substrate.calibrate(...) first)")
        object.__setattr__(self, "overrides",
                           _normalize_overrides(self.overrides))

    @property
    def name(self) -> str:
        return self.imc.mode

    @property
    def trace_key(self):
        """Identity of the computation this substrate runs, calibration
        values excluded (they may be swapped without changing it)."""
        return (self.imc, self.policy, self.overrides)

    def _override_for(self, site: Optional[str]) -> Optional[SiteOverride]:
        if not self.overrides:
            return None
        d = dict(self.overrides)
        if site is not None:
            if site in d:
                return d[site]
            group = site.split(".", 1)[0]
            if group in d:
                return d[group]
        return d.get(DEFAULT_SITE)

    def site_config(self, site: Optional[str] = None) -> IMCConfig:
        """The effective knobs at ``site`` (overrides applied)."""
        ov = self._override_for(site)
        if ov is None or not ov.imc_fields:
            return self.imc
        return dataclasses.replace(self.imc, **dict(ov.imc_fields))

    def site_stats(self, site: Optional[str] = None) -> Optional[SiteStats]:
        """Frozen quantizer stats for ``site`` (None under ``dynamic``)."""
        if self.policy != "frozen":
            return None
        stats = self.calibration.get(site)
        if stats is None:
            raise KeyError(
                f"frozen substrate has no calibration entry for site "
                f"{site!r} and no {DEFAULT_SITE!r} fallback")
        return stats

    def design_for_site(self, site: Optional[str] = None
                        ) -> Optional[DesignPoint]:
        """The design point billed for work at ``site`` (a site override
        wins over the substrate-wide design point)."""
        ov = self._override_for(site)
        if ov is not None and ov.design is not None:
            return ov.design
        return self.design

    def frozen(self, calibration: Calibration) -> "Substrate":
        return dataclasses.replace(self, policy="frozen",
                                   calibration=calibration)

    def with_design(self, design: DesignPoint) -> "Substrate":
        return dataclasses.replace(self, design=design)

    def with_overrides(self, overrides) -> "Substrate":
        return dataclasses.replace(self,
                                   overrides=_normalize_overrides(overrides))

    def dynamic(self) -> "Substrate":
        return dataclasses.replace(self, policy="dynamic", calibration=None)

    def calibrate(self, fn, batches: Iterable[Any]) -> "Substrate":
        """Run ``fn(batch)`` for each reference batch under a recorder and
        return the frozen substrate."""
        rec = CalibrationRecorder()
        with recording(rec), torch.no_grad():
            for batch in batches:
                fn(batch)
        return self.frozen(rec.finalize())


class _ModalSubstrate(Substrate):
    """Shared constructor: a ready-made ``imc=IMCConfig`` (mode must match)
    or IMCConfig knobs as keywords."""

    MODE = ""

    def __init__(self, *, imc: Optional[IMCConfig] = None,
                 policy: str = "dynamic",
                 calibration: Optional[Calibration] = None,
                 design: Optional[DesignPoint] = None, overrides=(),
                 **knobs):
        if imc is None:
            imc = IMCConfig(mode=self.MODE, **knobs)
        else:
            if knobs:
                imc = dataclasses.replace(imc, **knobs)
            if imc.mode != self.MODE:
                raise ValueError(f"{type(self).__name__} wants mode "
                                 f"{self.MODE!r}, got {imc.mode!r}")
        super().__init__(imc=imc, policy=policy, calibration=calibration,
                         design=design, overrides=overrides)


class DigitalSubstrate(_ModalSubstrate):
    """Plain matmuls - the baseline every IMC substrate is compared against."""

    MODE = "digital"


class AnalyticIMC(_ModalSubstrate):
    """Folded-noise IMC model (paper eqs. 10-15)."""

    MODE = "imc_analytic"


class BitSerialIMC(_ModalSubstrate):
    """Bit-exact QS-Arch simulation through the bit-serial kernel."""

    MODE = "imc_bitserial"


DIGITAL_SUBSTRATE = DigitalSubstrate()

_BY_MODE = {
    DigitalSubstrate.MODE: DigitalSubstrate,
    AnalyticIMC.MODE: AnalyticIMC,
    BitSerialIMC.MODE: BitSerialIMC,
}


def as_substrate(obj: Union[None, Substrate, IMCConfig]) -> Substrate:
    """Normalize an execution config to a Substrate (a bare IMCConfig is the
    equivalent dynamic-policy substrate)."""
    if obj is None:
        return DIGITAL_SUBSTRATE
    if isinstance(obj, Substrate):
        return obj
    if isinstance(obj, IMCConfig):
        cls = _BY_MODE.get(obj.mode)
        return Substrate(imc=obj) if cls is None else cls(imc=obj)
    raise TypeError(f"cannot interpret {type(obj).__name__} as a Substrate")


def substrate_for_design(pt: DesignPoint, **kw) -> Substrate:
    """The substrate a ``core.design`` design point implies: QS points run
    bit-serial planes (:class:`BitSerialIMC`); QR and CM points convert a full
    dot product per ADC read, which :class:`AnalyticIMC` models.  The design
    point rides along for billing (``launch.metering``)."""
    if pt.arch_kind == "qs":
        return BitSerialIMC(bx=pt.bx, bw=pt.bw, b_adc=pt.b_adc,
                            rows=pt.n_bank, v_wl=pt.knob, design=pt, **kw)
    return AnalyticIMC(bx=pt.bx, bw=pt.bw, b_adc=pt.b_adc,
                       snr_a_db=pt.snr_a_db, design=pt, **kw)


def substrate_ladder(pt: DesignPoint, steps: int = 2, min_b_adc: int = 2,
                     **kw) -> List[Substrate]:
    """Substrates stepping DOWN the EDAP frontier from ``pt``
    (``core.design.frontier_ladder``): index 0 is ``pt`` itself, each later
    entry drops one bit of output-ADC precision (lower SNR_T, energy and
    delay per DP).  ``launch.scheduler.PressureController`` walks it under
    overload."""
    from repro_torch.core.design import frontier_ladder

    return [substrate_for_design(p, **kw)
            for p in frontier_ladder(pt, steps=steps, min_b_adc=min_b_adc)]


def calibrate_model(cfg, params, token_batches):
    """Freeze ``cfg``'s substrate against reference ``token_batches``: runs
    ``models.forward`` once per ``(B, S)`` batch under a recorder (every
    non-digital site executes the noiseless fakequant proxy) and returns
    ``cfg`` with the frozen substrate installed."""
    from repro_torch.models.model import forward

    sub = as_substrate(cfg.imc).dynamic()
    run_cfg = cfg.replace(imc=sub)
    device = params["embed"].device

    def one(batch):
        forward(params, run_cfg, torch.as_tensor(batch, dtype=torch.int64,
                                                 device=device))

    return cfg.replace(imc=sub.calibrate(one, token_batches))
