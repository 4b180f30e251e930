"""Kernel-exact (bn-aligned) epitome spec design for a layer inventory.

The parts of ``repro.pim.plan`` that the ResNet and LM paths read: the spec
designer behind ``get_resnet`` and ``tiny_resnet(specs="auto")``, the
one-spec legalizer behind ``models.config.EpitomeSettings.layer_config``,
and the packed scale-grid shape.  Plan artifacts and search are not ported
yet.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

from ..core.epitome import EpitomeSpec
from .workloads import LayerShape


def is_kernel_exact(spec: EpitomeSpec) -> bool:
    """The fused kernels' OFAT col-block table samples exactly the same W
    as ``reconstruct`` iff every column offset is bn-aligned (row offsets
    are always free: fold_rows is exact for any row map)."""
    return bool((spec.col_offsets() % spec.bn == 0).all())


def _aligned_candidates(M: int, N: int, area: float,
                        patch: Tuple[int, int]) -> Iterator[EpitomeSpec]:
    """Kernel-exact specs for an (M, N) layer near a target epitome area:
    column designs restricted to wrap (n == bn) / identity (n == N) and row
    counts near area/n (bm multiples plus the exact value)."""
    bm0, bn0 = patch
    bm, bn = min(bm0, M), min(bn0, N)
    n_cands = {bn} | ({N} if N % bn == 0 else set())
    for n in sorted(n_cands):
        m_t = area / n
        for m in {max(bm, int(m_t) // bm * bm),
                  max(bm, -(-int(m_t) // bm) * bm),
                  max(bm, int(round(m_t))),
                  M}:
            m = min(m, M)
            if m * n >= M * N:          # not actually smaller -> not a spec
                continue
            yield EpitomeSpec(M=M, N=N, m=m, n=n, bm=bm, bn=bn)


def legalize_spec(layer: LayerShape, spec: Optional[EpitomeSpec],
                  patch: Tuple[int, int]
                  ) -> Tuple[Optional[EpitomeSpec], float]:
    """Snap one searched spec to the nearest kernel-exact family at the
    execution patch.  Returns (legal spec, relative epitome-area change).
    Dense stays dense; a layer with no legal compressed family goes dense
    with the area growth reported as its snap error."""
    if spec is None:
        return None, 0.0
    M, N = layer.rows, layer.cols
    area = spec.m * spec.n
    best, best_err = None, math.inf
    for cand in _aligned_candidates(M, N, area, patch):
        err = abs(cand.m * cand.n - area) / area
        if err < best_err:
            best, best_err = cand, err
    if best is None:
        return None, abs(M * N - area) / area
    assert is_kernel_exact(best), best
    return best, best_err


def pack_grid(spec: EpitomeSpec, tile: int = 256) -> Tuple[int, int]:
    """(ceil(m/bk), n/bn) shape of a packed epitome's Es/Ez scale grids: a
    mirror of ``kernels.ops.pack_blocks`` that needs no kernel module,
    including ``_pick_bk_quant``'s prime/odd-m fallback (the largest
    standard block not exceeding min(tile, m))."""
    blocks = (256, 128, 64, 32, 16, 8)
    bk = next((b for b in blocks if b <= tile and spec.m % b == 0), None)
    if bk is None:
        bk = next((b for b in blocks if b <= min(tile, spec.m)), spec.m)
    return -(-spec.m // bk), -(-spec.n // spec.bn)


def plan_conv_specs(layers: Sequence[LayerShape], target_cr: float = 2.0,
                    patch: Tuple[int, int] = (8, 8)
                    ) -> List[Optional[EpitomeSpec]]:
    """Kernel-exact epitome specs for a LayerShape inventory.

    Column designs are restricted to the bn-aligned families — wrap
    (n == bn) or identity (n == N) — so the kernel modes' OFAT col-block
    table samples exactly the same W as ``reconstruct``; row offsets stay
    unrestricted because fold_rows is exact for any row map.  Layers too
    small to compress stay dense (None)."""
    specs: List[Optional[EpitomeSpec]] = []
    for l in layers:
        budget = l.rows * l.cols / target_cr
        best, best_err = None, math.inf
        for s in _aligned_candidates(l.rows, l.cols, budget, patch):
            err = abs(s.compression_rate - target_cr) / target_cr
            if err < best_err:
                best, best_err = s, err
        specs.append(best)
    return specs
