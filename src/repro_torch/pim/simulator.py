"""Behaviour-level latency/energy simulator for EPIM (MNSIM-style).

Structural model (paper §5.1):
 * A dense conv activates its crossbars once per output position:
   ``rounds = out_hw^2``; all tiles (and bit slices) fire in parallel.
 * An epitome stores only (m x n) on silicon; the gm x gn *virtual* patch
   grid is realized by re-activating the physical tiles serially:
   ``activation_factor = ceil(virtual_tiles / physical_tiles)`` — "the
   overall latency increase is roughly proportional to the compression
   rate" (Fig. 4a).
 * Epitome rounds pay the IFAT/IFRT/OFAT lookups (§4.3).
 * Buffer traffic scales with activation rounds (the paper's §5.1 energy
   explanation: "the output buffer has to be written four times more");
   channel wrapping (§5.3) divides the column-side activations and writes
   by the wrap factor r.

Event counters per layer:
   R  — crossbar round-time events (rounds x per-round sense/ADC time)
   V  — buffer traffic volume     (rounds x (rows_read + cols_written))
   C  — MAC/ADC core energy events (invariant under epitome: same math)
   X  — crossbars occupied

Linear cost model, coefficients calibrated on five Table-1/Fig-4 anchors
(see `calibrate`):  latency = A*R + B*V ;  energy = s*C + w*V + p*X.
Everything downstream (r101 rows, wrapping/evo gains, EDP, quantized rows)
is a structural prediction, not a fit.

A copy of ``repro.pim.simulator``, float64 operation for operation, so that
both packages predict the same costs and search the same plans.  Refitting
the tiny coefficients on measured times (``calibrate_tiny_coefficients``)
comes with the tuning slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from ..core.epitome import EpitomeSpec
from .tables import HardwareLUT
from .workloads import LayerShape
from .xbar import MappingConfig, layer_crossbars, tiles, utilization


@dataclasses.dataclass
class LayerCounters:
    name: str
    rounds: float
    R: float        # round-time events (incl. index-table overhead)
    V: float        # buffer traffic (elements)
    C: float        # core MAC/ADC events
    X: int          # crossbars
    params: int


@dataclasses.dataclass
class Coefficients:
    A: float = 1e-9      # s per round event
    B: float = 1e-12     # s per buffer element
    s: float = 1e-12     # J per core event
    w: float = 1e-13     # J per buffer element
    p: float = 1e-8      # J per crossbar (peripheral/static)


@dataclasses.dataclass
class SimResult:
    latency: float               # seconds
    energy: float                # joules
    xbars: int
    utilization: float
    layers: List[LayerCounters]

    @property
    def edp(self) -> float:
        return self.latency * self.energy

    def summary(self) -> dict:
        """JSON-ready cost record — what an EpitomePlan stores as its
        predicted cost (plan.py round-trips exactly these keys)."""
        return {
            "latency_s": float(self.latency),
            "energy_j": float(self.energy),
            "edp": float(self.edp),
            "xbars": int(self.xbars),
            "utilization": float(self.utilization),
        }

    def __str__(self) -> str:
        return (f"latency={self.latency*1e3:.1f}ms energy={self.energy*1e3:.1f}mJ "
                f"EDP={self.edp*1e6:.2f} xbars={self.xbars} util={self.utilization*100:.1f}%")


class PimSimulator:
    def __init__(self, mapping: Optional[MappingConfig] = None,
                 lut: Optional[HardwareLUT] = None,
                 coeff: Optional[Coefficients] = None):
        self.mapping = mapping or MappingConfig()
        self.lut = lut or HardwareLUT()
        self.coeff = coeff or Coefficients()

    # -- per-layer event counting -------------------------------------------
    def _layer(self, l: LayerShape, spec: Optional[EpitomeSpec],
               bits: Optional[int], wrapping: bool,
               act_bits: Optional[int] = None) -> LayerCounters:
        cfg, lut = self.mapping, self.lut
        xr, xc = cfg.xb_rows, cfg.xb_cols
        n_xbars = layer_crossbars(l, cfg, spec, bits)
        slices = cfg.slices(bits)
        # bit-serial input cycles & shift-add depth scale every per-round
        # event with the quantization widths (W*A* rows of Table 1)
        acyc = cfg.act_cycles(act_bits)
        acyc_ref = cfg.act_cycles(None)
        sl_ref = cfg.slices(None)
        # per-cycle time = fixed (DAC+xbar+ADC mux) + shift-add per slice;
        # tf/ts = 5.25 calibrated on the W9A9/W5A9 latency pair of Table 1
        tf_over_ts = 5.25
        qt = (acyc * (tf_over_ts + slices)) / (acyc_ref * (tf_over_ts + sl_ref))
        qe = (acyc * slices) / (acyc_ref * sl_ref)

        if spec is None:
            af = 1
            ra, ca = min(xr, l.rows), min(xc, l.cols)
            gm, gn = math.ceil(l.rows / xr), math.ceil(l.cols / xc)
            is_ep = False
        else:
            phys = tiles(spec.m, spec.n, cfg)
            gm, gn0 = spec.gm, spec.gn
            if wrapping:
                uniq, _ = spec.unique_col_blocks()
                gn = len(uniq)          # §5.3: only unique col blocks computed
            else:
                gn = gn0
            # amortized activation factor: patches stream back-to-back across
            # output positions, so the per-output activation count is the
            # fractional virtual/physical tile ratio ("latency increase is
            # roughly proportional to the compression rate", §5.1)
            af = max(1.0, gm * gn / phys)
            ra, ca = min(xr, spec.bm), min(xc, spec.bn)
            is_ep = True

        rounds = l.rounds * af
        # per-round sense time: xbar read + shared-ADC mux + (epitome tables)
        t_rel = 1.0 + (lut.t_adc / lut.t_round) * math.ceil(ca / lut.adc_share)
        if is_ep:
            t_rel += (lut.t_ifat + lut.t_ifrt + lut.t_ofat) / lut.t_round
        R = rounds * t_rel * qt
        # buffer traffic: input rows re-fetched per round; output partials are
        # read-modify-written on EVERY activation ("we need to store a feature
        # map in the buffer each time we activate a small kernel" — the
        # paper's 2-activation example costs 4x writes, i.e. writes scale
        # with af^2: af rounds x af partial visits), weighted by the relative
        # write cost (writes dominate, §5.1)
        wr_rel = lut.e_buf_wr / lut.e_buf_rd
        V = rounds * (ra * gm + af * ca * gn * wr_rel) * qe
        # core math events: ADC conversions per activation round, scaling
        # with bit-slices and input cycles
        C = l.rounds * (min(xr, l.rows) * math.ceil(l.rows / xr)
                        * min(xc, l.cols) * math.ceil(l.cols / xc) / xr) * qe
        return LayerCounters(l.name, rounds, R, V, C, n_xbars, l.params)

    # -- network level --------------------------------------------------------
    def counters(self, layers: Sequence[LayerShape],
                 specs: Optional[Sequence[Optional[EpitomeSpec]]] = None,
                 weight_bits: Optional[Sequence[Optional[int]]] = None,
                 wrapping: bool = False,
                 act_bits: Optional[int] = None) -> List[LayerCounters]:
        if specs is None:
            specs = [None] * len(layers)
        if weight_bits is None:
            weight_bits = [None] * len(layers)
        return [self._layer(l, s, b, wrapping, act_bits)
                for l, s, b in zip(layers, specs, weight_bits)]

    def simulate(self, layers: Sequence[LayerShape],
                 specs: Optional[Sequence[Optional[EpitomeSpec]]] = None,
                 weight_bits: Optional[Sequence[Optional[int]]] = None,
                 wrapping: bool = False,
                 act_bits: Optional[int] = None) -> SimResult:
        cs = self.counters(layers, specs, weight_bits, wrapping, act_bits)
        co = self.coeff
        latency = sum(co.A * c.R + co.B * c.V for c in cs)
        energy = sum(co.s * c.C + co.w * c.V + co.p * c.X for c in cs)
        xbars = sum(c.X for c in cs)
        util = utilization(layers, self.mapping, specs, weight_bits)
        return SimResult(latency, energy, xbars, util, cs)

    def simulate_plan(self, plan, *, wrapping: bool = True,
                      act_bits: Optional[int] = None) -> SimResult:
        """Simulate an EpitomePlan against its own arch inventory — the
        cost every planner stamps into ``plan.predicted``."""
        from .plan import inventory_for
        layers = inventory_for(plan.arch)()
        return self.simulate(layers, plan.specs(), plan.bits(),
                             wrapping=wrapping, act_bits=act_bits)


# ---------------------------------------------------------------------------
# Calibration on Table-1 / Fig-4 anchors
# ---------------------------------------------------------------------------
def _sums(cs: List[LayerCounters]):
    return (sum(c.R for c in cs), sum(c.V for c in cs),
            sum(c.C for c in cs), float(sum(c.X for c in cs)))


def calibrate(sim: PimSimulator, layers: Sequence[LayerShape],
              specs_ep: Sequence[Optional[EpitomeSpec]],
              specs_fig4: Sequence[Optional[EpitomeSpec]],
              lat_base: float, en_base: float,
              lat_ep: float, en_ep: float,
              en_fig4: float) -> PimSimulator:
    """Solve the 2x2 latency system on (dense, epitome-1024x256) and the 3x3
    energy system on (dense, epitome-1024x256, all-layer-256x256 [Fig 4]).

    The epitome *latency ratio* of the 256x256 design (paper: 3.86x) and the
    whole ResNet-101 column are NOT fitted — they are validation targets.
    """
    import numpy as np
    b = _sums(sim.counters(layers))
    e = _sums(sim.counters(layers, specs_ep))
    f = _sums(sim.counters(layers, specs_fig4))

    A, B = np.linalg.solve(np.array([[b[0], b[1]], [e[0], e[1]]]),
                           np.array([lat_base, lat_ep]))
    M = np.array([[b[2], b[1], b[3]],
                  [e[2], e[1], e[3]],
                  [f[2], f[1], f[3]]])
    y = np.array([en_base, en_ep, en_fig4])
    s, w, p = np.linalg.solve(M, y)
    if min(s, w, p) < 0:
        # project to the non-negative cone: re-solve each 2-coefficient
        # submodel (zeroing one coefficient) by least squares, keep the best
        best, best_r = None, np.inf
        for drop in range(3):
            keep = [i for i in range(3) if i != drop]
            sol, res, *_ = np.linalg.lstsq(M[:, keep], y, rcond=None)
            if (sol < 0).any():
                continue
            r = float(np.sum((M[:, keep] @ sol - y) ** 2))
            if r < best_r:
                full = np.zeros(3)
                full[keep] = sol
                best, best_r = full, r
        if best is None:
            raise ValueError("energy calibration infeasible")
        s, w, p = best
    co = sim.coeff
    co.A, co.B, co.s, co.w, co.p = float(A), float(B), float(s), float(w), float(p)
    if min(co.A, co.B) < 0:
        raise ValueError(f"negative latency coefficient: A={co.A} B={co.B}")
    return sim


def tiny_calibrated_simulator() -> PimSimulator:
    """The (8, 8)-crossbar simulator for tiny-resnet with the reference's
    tiny latency coefficients (tables.TINY_CALIBRATION).  Energy
    coefficients stay at the structural defaults."""
    from .tables import TINY_CALIBRATION as tc
    sim = PimSimulator(MappingConfig(xb_rows=8, xb_cols=8))
    sim.coeff.A, sim.coeff.B = tc.A, tc.B
    return sim


def default_calibrated_simulator() -> PimSimulator:
    """Simulator calibrated on the paper's ResNet-50 anchors (Table 1 FP32
    rows + Fig 4's 2.13x energy for the uniform 256x256 design)."""
    from .workloads import resnet50_layers
    from .xbar import uniform_epitome_specs
    from .evo import all_layer_uniform_specs

    layers = resnet50_layers()
    sim = PimSimulator()
    specs_ep = uniform_epitome_specs(layers, 1024, 256, sim.mapping)
    specs_fig4 = all_layer_uniform_specs(layers, 256, 256, sim.mapping)
    return calibrate(sim, layers, specs_ep, specs_fig4,
                     lat_base=139.8e-3, en_base=214.0e-3,
                     lat_ep=167.7e-3, en_ep=194.8e-3,
                     en_fig4=2.13 * 214.0e-3)
