"""Epitome-aware quantization (EPIM §4.2, Eqs. 2-5, Table 2).

Three ingredients, composable:

1. *naive*      — one (alpha, beta) = (min, max) range for the whole tensor.
2. *+crossbar*  — one scaling factor per crossbar-sized tile.
3. *+overlap*   — the range is a weighted sum of the min/max over the
                  high-repetition ("overlap") region and the rest (Eq. 4-5).

Asymmetric affine quantization per Eq. 2-3:
    Q(r) = round(r / S) - Z,   S = (beta - alpha) / (2^k - 1)

Counterpart of ``repro.core.quant``.  Every step is the same float32
operation in the same order as the reference, so the int8 codes of
``quantize_epitome_packed`` equal the reference's; ``torch.round`` and
``jnp.round`` both round half to even.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from .epitome import EpitomeSpec, overlap_mask


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 8
    per_crossbar: bool = True        # paper's "+ Adjust with Crossbars"
    overlap_weighted: bool = True    # paper's "+ Adjusted with Overlap"
    w1: float = 0.7                  # weight of the overlap (center) region
    w2: float = 0.3                  # weight of the rest  (w1 + w2 = 1)
    tile: int = 256                  # crossbar size / scale tile
    symmetric: bool = False

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a float32 scalar on ``like``'s device (the weak
    typing jnp applies to Python scalars).  Filled on the device: copying
    it from the host would wait for the stream, and the dense layers of a
    quantized model run this on every forward."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Range selection
# ---------------------------------------------------------------------------
def _masked_min_max(x: torch.Tensor, mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    big = _f32(torch.finfo(x.dtype).max, x)
    mn = torch.where(mask, x, big).min()
    mx = torch.where(mask, x, -big).max()
    return mn, mx


@functools.lru_cache(maxsize=64)
def _overlap_mask_on(spec: EpitomeSpec, device: torch.device) -> torch.Tensor:
    """overlap_mask(spec) on ``device``, computed and copied once per
    (spec, device): a model packs every layer of one spec against it."""
    return torch.as_tensor(overlap_mask(spec), device=device)


def overlap_weighted_range(E: torch.Tensor, spec: EpitomeSpec, w1: float,
                           w2: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 4-5: weighted min/max over the overlap region vs. the rest."""
    m = _overlap_mask_on(spec, E.device)
    any_ovl = m.any()
    mn_o, mx_o = _masked_min_max(E, m)
    mn_r, mx_r = _masked_min_max(E, ~m)
    # degenerate cases: everything (or nothing) is overlap -> plain min/max
    mn_o = torch.where(any_ovl, mn_o, mn_r)
    mx_o = torch.where(any_ovl, mx_o, mx_r)
    all_ovl = m.all()
    mn_r = torch.where(all_ovl, mn_o, mn_r)
    mx_r = torch.where(all_ovl, mx_o, mx_r)
    w1t, w2t = _f32(w1, E), _f32(w2, E)
    alpha = w1t * mn_o + w2t * mn_r
    beta = w1t * mx_o + w2t * mx_r
    return alpha, beta


def tensor_range(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return x.min(), x.max()


# ---------------------------------------------------------------------------
# Affine quantize / dequantize (Eq. 2-3)
# ---------------------------------------------------------------------------
def scale_zero(alpha: torch.Tensor, beta: torch.Tensor, cfg: QuantConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    eps = _f32(1e-12, alpha)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, which can move S by one ulp
    levels = _f32(cfg.levels, alpha)
    if cfg.symmetric:
        amax = torch.maximum(alpha.abs(), beta.abs())
        S = (2 * amax) / levels
        Z = torch.zeros_like(S)
    else:
        S = (beta - alpha) / levels
        Z = torch.round(alpha / torch.maximum(S, eps))
    S = torch.maximum(S, eps)
    return S, Z


def quantize(x: torch.Tensor, S: torch.Tensor, Z: torch.Tensor,
             cfg: QuantConfig) -> torch.Tensor:
    q = torch.round(x / S) - Z
    lo = -(1 << (cfg.bits - 1)) if cfg.symmetric else 0
    hi = lo + cfg.levels
    return q.clamp(lo, hi)


def dequantize(q: torch.Tensor, S: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    return (q + Z) * S


# ---------------------------------------------------------------------------
# Per-crossbar tiling
# ---------------------------------------------------------------------------
def _edge_pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Pad (m, n) to (rows, cols) by repeating the last row and column (the
    reference's ``jnp.pad(mode="edge")``): neutral under min/max."""
    m, n = x.shape
    if rows == m and cols == n:
        return x
    ri = torch.arange(rows, device=x.device).clamp_max(m - 1)
    ci = torch.arange(cols, device=x.device).clamp_max(n - 1)
    return x[ri[:, None], ci[None, :]]


def _tile_reduce(x: torch.Tensor, tile: int, fn) -> torch.Tensor:
    """Reduce (m, n) -> (gm, gn) per (tile x tile) block, ragged edges
    edge-padded."""
    return _block_reduce(x, tile, tile, fn)


def per_crossbar_range(E: torch.Tensor, cfg: QuantConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha, beta) per crossbar tile, shape (gm, gn)."""
    return _tile_reduce(E, cfg.tile, torch.amin), _tile_reduce(E, cfg.tile, torch.amax)


def _expand_tiles(t: torch.Tensor, shape: Tuple[int, int], tile: int) -> torch.Tensor:
    m, n = shape
    return _expand_blocks(t, tile, tile)[:m, :n]


# ---------------------------------------------------------------------------
# The full epitome-aware quantizer
# ---------------------------------------------------------------------------
def epitome_ranges(E: torch.Tensor, spec: Optional[EpitomeSpec],
                   cfg: QuantConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Produce (alpha, beta) maps of E.shape combining both paper tricks."""
    if cfg.overlap_weighted and spec is not None:
        a_g, b_g = overlap_weighted_range(E, spec, cfg.w1, cfg.w2)
    else:
        a_g, b_g = tensor_range(E)

    if cfg.per_crossbar:
        a_t, b_t = per_crossbar_range(E, cfg)
        if cfg.overlap_weighted and spec is not None:
            # per-crossbar range, clipped toward the overlap-weighted global
            # range (the outlier-robust envelope)
            a_t = torch.maximum(a_t, a_g)
            b_t = torch.minimum(b_t, b_g)
            bad = a_t >= b_t                      # never an inverted range
            a_t = torch.where(bad, a_g.expand_as(a_t), a_t)
            b_t = torch.where(bad, b_g.expand_as(b_t), b_t)
        alpha = _expand_tiles(a_t, E.shape, cfg.tile)
        beta = _expand_tiles(b_t, E.shape, cfg.tile)
    else:
        alpha = a_g.expand(E.shape)
        beta = b_g.expand(E.shape)
    return alpha, beta


def quantize_epitome(E: torch.Tensor, spec: Optional[EpitomeSpec],
                     cfg: QuantConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q_int, S, Z) where S/Z have E's shape (expanded tiles)."""
    alpha, beta = epitome_ranges(E, spec, cfg)
    S, Z = scale_zero(alpha, beta, cfg)
    return quantize(E, S, Z, cfg), S, Z


# ---------------------------------------------------------------------------
# Packed (int8-storage) quantization — the kernel-side contract
# ---------------------------------------------------------------------------
def _block_reduce(x: torch.Tensor, bk: int, bn: int, fn) -> torch.Tensor:
    """Reduce an (m, n) map to (ceil(m/bk), ceil(n/bn)) per (bk x bn)
    block; ragged edges are edge-replicated, so the ranges of real rows
    never see the kernel-side zero padding."""
    m, n = x.shape
    gm, gn = -(-m // bk), -(-n // bn)
    x = _edge_pad(x, gm * bk, gn * bn)
    return fn(x.reshape(gm, bk, gn, bn), dim=(1, 3))


def _expand_blocks(t: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    return t.repeat_interleave(bk, 0).repeat_interleave(bn, 1)


def code_shift(cfg: QuantConfig) -> int:
    """Shift folding the unsigned code range into int8: storing q - shift and
    z + shift leaves (q + z) * s unchanged (symmetric codes are already
    signed, shift 0)."""
    return 0 if cfg.symmetric else 1 << (cfg.bits - 1)


def quantize_epitome_packed(E: torch.Tensor, spec: Optional[EpitomeSpec],
                            cfg: QuantConfig, block: Tuple[int, int]
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack an epitome for the fused quant kernel.

    Returns (q, scales, zeros): q is (m, n) **int8** codes; scales/zeros are
    (ceil(m/bk), ceil(n/bn)) float32, one pair per kernel block.  The scale
    grid keeps its ceil shape when blocks tile m raggedly; the caller
    zero-pads q's rows at kernel-call time instead."""
    bk, bn = block
    m, n = E.shape
    alpha, beta = epitome_ranges(E, spec, cfg)
    a_b = _block_reduce(alpha, bk, bn, torch.amin)
    b_b = _block_reduce(beta, bk, bn, torch.amax)
    S, Z = scale_zero(a_b, b_b, cfg)
    q = quantize(E, _expand_blocks(S, bk, bn)[:m, :n],
                 _expand_blocks(Z, bk, bn)[:m, :n], cfg)
    shift = code_shift(cfg)
    return (q - shift).to(torch.int8), S, Z + shift


def dequantize_packed(q: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
                      block: Tuple[int, int]) -> torch.Tensor:
    """Inverse of quantize_epitome_packed: (q + z) * s per block (the plain
    dequant the kernels' in-register dequant is held against)."""
    bk, bn = block
    m, n = q.shape
    S = _expand_blocks(scales, bk, bn)[:m, :n]
    Z = _expand_blocks(zeros, bk, bn)[:m, :n]
    return (q.to(torch.float32) + Z) * S


# ---------------------------------------------------------------------------
# Fake quant with straight-through estimator (for QAT retraining, §7.1)
# ---------------------------------------------------------------------------
class _STE(torch.autograd.Function):
    """Forward returns the quantized value; backward passes the gradient
    straight through to the unquantized input."""

    @staticmethod
    def forward(ctx, x, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(E: torch.Tensor, spec: Optional[EpitomeSpec],
               cfg: QuantConfig) -> torch.Tensor:
    with torch.no_grad():
        q, S, Z = quantize_epitome(E, spec, cfg)
        y = dequantize(q, S, Z).to(E.dtype)
    return _STE.apply(E, y)

