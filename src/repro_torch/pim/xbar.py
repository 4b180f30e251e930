"""Crossbar mapping and #XB counting (EPIM §4.1, mapping strategy of [13]).

Calibrated reproduction of Table 1's #XB arithmetic, a copy of
``repro.pim.xbar`` so that both packages count the same crossbars.  The
geometry that reproduces the paper's counts:

 * crossbar = 128 word lines x 256 bit lines, 2-bit cells;
 * FP32 deployed as 32-bit fixed point -> 16 bit-slices;
 * quantized weights are sign-magnitude: slices = ceil((bits-1)/2)
   (the sign rides on the differential word-line pulse, costing no cells);
 * a weight matrix occupies ceil(rows/128) * ceil(cols/256) tiles, each tile
   replicated per bit-slice;
 * the paper's uniform "1024x256" design epitomizes exactly the layers with
   rows >= 1024 (epitome row capacity) or cols == 1024 (the bottleneck
   expansion convs) — the assignment that matches the paper's 5696/10592.

Residuals vs. the paper: dense ResNet-50 13184 vs 13120 (+0.5 %), ResNet-101
22432 vs 22912 (-2.1 %); epitome 5632 vs 5696, 10528 vs 10592 (~1 %);
CR 2.34/2.13 vs 2.30/2.16.  W3A9's 618 is the one row our slicing cannot
produce (we predict 352, i.e. *better*); Table 1's W3 row appears to keep a
subset of layers at 2 slices — reproduced via the mixed-precision path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from ..core.epitome import EpitomeSpec
from .workloads import LayerShape


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    xb_rows: int = 128          # word lines per crossbar
    xb_cols: int = 256          # bit lines per crossbar
    cell_bits: int = 2          # paper: "well-explored 2-bit memristor cells"
    fp32_fixed_bits: int = 32   # FP32 deployed as 32-bit fixed point
    dac_bits: int = 2           # input bits per word-line pulse (bit-serial)
    act_fixed_bits: int = 16    # FP32 activations fed as 16-bit fixed inputs

    def act_cycles(self, act_bits: Optional[int]) -> int:
        """Bit-serial input cycles per activation round (no sign trick on
        the DAC side — inputs are fed magnitude-serially)."""
        bits = self.act_fixed_bits if act_bits is None else act_bits
        return max(1, math.ceil(bits / self.dac_bits))

    def slices(self, weight_bits: Optional[int]) -> int:
        """Physical crossbars per logical tile for a given weight bitwidth."""
        if weight_bits is None:
            return math.ceil(self.fp32_fixed_bits / self.cell_bits)
        # sign-magnitude: the sign costs no cells
        return max(1, math.ceil((weight_bits - 1) / self.cell_bits))


def tiles(rows: int, cols: int, cfg: MappingConfig) -> int:
    return math.ceil(rows / cfg.xb_rows) * math.ceil(cols / cfg.xb_cols)


def layer_crossbars(layer: LayerShape, cfg: MappingConfig,
                    spec: Optional[EpitomeSpec] = None,
                    weight_bits: Optional[int] = None) -> int:
    """#XBs for one layer, optionally epitomized / quantized."""
    if spec is None:
        t = tiles(layer.rows, layer.cols, cfg)
    else:
        t = tiles(spec.m, spec.n, cfg)
    return t * cfg.slices(weight_bits)


def layer_cells_used(layer: LayerShape, cfg: MappingConfig,
                     spec: Optional[EpitomeSpec] = None,
                     weight_bits: Optional[int] = None) -> int:
    """Occupied cells (for the paper's memristor-utilization column)."""
    rows, cols = (layer.rows, layer.cols) if spec is None else (spec.m, spec.n)
    return rows * cols * cfg.slices(weight_bits)


def count_crossbars(layers: Sequence[LayerShape], cfg: MappingConfig,
                    specs: Optional[Sequence[Optional[EpitomeSpec]]] = None,
                    weight_bits: Optional[Sequence[Optional[int]]] = None) -> int:
    if specs is None:
        specs = [None] * len(layers)
    if weight_bits is None:
        weight_bits = [None] * len(layers)
    return sum(layer_crossbars(l, cfg, s, b)
               for l, s, b in zip(layers, specs, weight_bits))


def utilization(layers: Sequence[LayerShape], cfg: MappingConfig,
                specs: Optional[Sequence[Optional[EpitomeSpec]]] = None,
                weight_bits: Optional[Sequence[Optional[int]]] = None) -> float:
    if specs is None:
        specs = [None] * len(layers)
    if weight_bits is None:
        weight_bits = [None] * len(layers)
    used = sum(layer_cells_used(l, cfg, s, b)
               for l, s, b in zip(layers, specs, weight_bits))
    total = sum(
        layer_crossbars(l, cfg, s, b) * cfg.xb_rows * cfg.xb_cols
        for l, s, b in zip(layers, specs, weight_bits))
    return used / total


# ---------------------------------------------------------------------------
# Epitome assignment for a whole network (the "epitome designer", Fig. 2a)
# ---------------------------------------------------------------------------
def make_spec(l: LayerShape, m: int, n: int,
              cfg: MappingConfig) -> Optional[EpitomeSpec]:
    """The one spec constructor every planner shares: clamp the requested
    (m, n) to the layer, patch at crossbar geometry, and return None when
    the epitome would not actually be smaller than the weight."""
    em, en = min(m, l.rows), min(n, l.cols)
    if em * en >= l.rows * l.cols:
        return None
    bm, bn = min(cfg.xb_rows, em), min(cfg.xb_cols, en)
    return EpitomeSpec(M=l.rows, N=l.cols, m=em, n=en, bm=bm, bn=bn)


def uniform_epitome_specs(layers: Sequence[LayerShape], m: int, n: int,
                          cfg: MappingConfig) -> List[Optional[EpitomeSpec]]:
    """The paper's uniform design, e.g. "1024x256" (c_in*p*q x c_out).

    Assignment rule calibrated to Table 1: layers whose word-line extent
    reaches the epitome's row capacity (rows >= m) are epitomized, as are
    the bottleneck expansion convs (cols == 1024); everything else (early /
    small layers) stays dense — matching the paper keeping low-parameter
    layers uncompressed (§5.2 Fig. 3 shows layer 9 barely shrinks)."""
    out: List[Optional[EpitomeSpec]] = []
    for l in layers:
        use = l.rows >= m or l.cols == 1024
        out.append(make_spec(l, m, n, cfg) if use else None)
    return out
