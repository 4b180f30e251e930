"""One cost interface for plan search and plan artifacts.

``CostModel`` is what the evolution search ranks by (``total()``, seconds)
and what planners stamp into ``provenance['cost']`` (``plan_cost()``);
``AnalyticCost`` wraps the ``PimSimulator``'s linear latency model, per
layer.  A copy of the analytic half of ``repro.pim.costmodel``, so that
both packages stamp the same records.  The measured half (``MeasuredCost``,
per-layer kernel latency timed on the device and cached) comes with the
tuning slice, which times with CUDA events.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from ..core.epitome import EpitomeSpec
from .simulator import PimSimulator
from .workloads import LayerShape


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """One layer's cost under a CostModel, ready for provenance."""
    name: str
    analytic_s: float                 # simulator latency, seconds
    measured_s: Optional[float]       # measured kernel latency; None when
                                      # the backend is analytic-only
    key: str = ""                     # memo/cache key ("" for analytic)
    source: str = "analytic"          # analytic | timed | cache | memo

    def record(self) -> Dict[str, Any]:
        return {"name": self.name, "analytic_s": float(self.analytic_s),
                "measured_s": (None if self.measured_s is None
                               else float(self.measured_s)),
                "key": self.key, "source": self.source}


@dataclasses.dataclass
class PlanCost:
    """A whole plan's cost record (what provenance['cost'] stores)."""
    model: str                        # 'analytic' | 'measured'
    t: int                            # activation batch the T's derive from
    layers: List[LayerCost]

    @property
    def analytic_s(self) -> float:
        return sum(c.analytic_s for c in self.layers)

    @property
    def measured_s(self) -> Optional[float]:
        vals = [c.measured_s for c in self.layers]
        if any(v is None for v in vals):
            return None
        return sum(vals)

    def record(self) -> Dict[str, Any]:
        m = self.measured_s
        return {"model": self.model, "t": int(self.t),
                "analytic_s": float(self.analytic_s),
                "measured_s": None if m is None else float(m),
                "layers": [c.record() for c in self.layers]}


def _norm_bits(bits, n: int) -> List[Optional[int]]:
    if bits is None:
        return [None] * n
    return list(bits)


class CostModel:
    """Interface every plan-scoring backend implements.

    ``total()`` is the scalar the evolution search ranks by (seconds;
    ``None`` means this backend cannot score right now — callers degrade
    to analytic).  ``plan_cost()`` is the provenance form.
    """

    name = "abstract"

    def layer_costs(self, layers: Sequence[LayerShape],
                    specs: Sequence[Optional[EpitomeSpec]],
                    bits=None, *, t: Optional[int] = None,
                    act_bits: Optional[int] = None,
                    wrapping: bool = True) -> List[LayerCost]:
        raise NotImplementedError

    def total(self, layers, specs, bits=None, *, t: Optional[int] = None,
              act_bits: Optional[int] = None,
              wrapping: bool = True) -> Optional[float]:
        raise NotImplementedError

    def plan_cost(self, plan, *, t: Optional[int] = None) -> PlanCost:
        from .plan import inventory_for
        layers = inventory_for(plan.arch)()
        lcs = self.layer_costs(layers, plan.specs(), plan.bits(), t=t,
                               act_bits=plan.provenance.get("act_bits"))
        return PlanCost(self.name, t if t is not None else getattr(self, "t", 1),
                        lcs)


class AnalyticCost(CostModel):
    """The PimSimulator's linear latency model, per layer."""

    name = "analytic"

    def __init__(self, simulator: PimSimulator):
        self.sim = simulator

    def layer_costs(self, layers, specs, bits=None, *, t=None, act_bits=None,
                    wrapping=True) -> List[LayerCost]:
        bits = _norm_bits(bits, len(layers))
        cs = self.sim.counters(layers, specs, bits, wrapping, act_bits)
        co = self.sim.coeff
        return [LayerCost(c.name, float(co.A * c.R + co.B * c.V), None)
                for c in cs]

    def total(self, layers, specs, bits=None, *, t=None, act_bits=None,
              wrapping=True) -> float:
        return sum(c.analytic_s for c in self.layer_costs(
            layers, specs, bits, act_bits=act_bits, wrapping=wrapping))


def analytic_cost_for(arch: str) -> AnalyticCost:
    from .plan import simulator_for
    return AnalyticCost(simulator_for(arch))


def cost_model_for(arch: str, kind: str = "analytic") -> CostModel:
    """'analytic' backend for an arch; 'measured' comes with the tuning
    slice."""
    if kind == "analytic":
        return analytic_cost_for(arch)
    if kind == "measured":
        raise NotImplementedError(
            "the measured cost model (MeasuredCost: kernel latency timed on "
            "the card) comes with the tuning slice of the port "
            "(ROADMAP item 13); use 'analytic'")
    raise ValueError(f"unknown cost model {kind!r}; "
                     "expected 'analytic' or 'measured'")
