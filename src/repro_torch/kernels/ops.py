"""Public wrappers around the epitome matmul kernels.

``epitome_matmul`` is what core/layers.py mode="kernel" calls: it folds the
activations into epitome-row space (the IFRT analogue), runs the kernel with
the static OFAT column-block table, and trims the result to the virtual
width.  ``quant_epitome_matmul`` does the same through the int8 kernels and
returns x's dtype; ``wkv6`` is the RWKV6 recurrence of the LM's prefill,
``mamba_scan`` the Mamba layers' selective scan.
Block picks follow ``repro.kernels.ops`` integer for integer, since they
feed plan provenance; the CUDA kernels mask ragged rows and contraction
edges themselves, so no wrapper pads rows or codes before a launch.

Tensors on the CPU run every kernel's plain version; tensors on a CUDA
device launch the kernels.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.epitome import EpitomeSpec, fold_tables, gather_sum, preimage_table
from ..core.quant import QuantConfig, quantize_epitome_packed
from .epitome_matmul import epitome_matmul_blocks
from .quant_epitome_matmul import (quant_epitome_matmul_blocks,
                                   quant_epitome_matmul_fused_fold)
from .quant_matmul import quant_matmul as _quant_matmul
from .mamba_scan import MambaScan
from .wkv6 import WKV6


def kernel_col_blocks(spec: EpitomeSpec,
                      bn: Optional[int] = None) -> np.ndarray:
    """Static OFAT table: output block j <- epitome column block cb[j].
    Exact only for bn-aligned column offsets; unaligned spread offsets are
    snapped to their containing block.  With ``bn`` (a divisor of spec.bn),
    each spec.bn-wide virtual block splits into spec.bn/bn sub-blocks;
    requires bn-aligned offsets (``col_blocks_splittable``)."""
    offs = spec.col_offsets()
    if bn is None or bn == spec.bn:
        return (offs // spec.bn).astype(np.int32)
    assert spec.bn % bn == 0 and (offs % bn == 0).all(), (spec, bn)
    sub = spec.bn // bn
    cb = offs[:, None] // bn + np.arange(sub)[None, :]
    return cb.reshape(-1).astype(np.int32)


def col_blocks_splittable(spec: EpitomeSpec, bn: int) -> bool:
    """True iff ``kernel_col_blocks(spec, bn)`` samples exactly the same W
    columns as the spec.bn table."""
    if bn == spec.bn:
        return True
    return (spec.bn % bn == 0 and spec.n % bn == 0
            and bool((spec.col_offsets() % bn == 0).all()))


class SpecTables(NamedTuple):
    """A spec's static index tables as tensors on one device."""
    fold: torch.Tensor          # (c*m,) int64 fold_table(spec), column by column
    col_blocks: torch.Tensor    # (gn*spec.bn/bn,) int32 kernel_col_blocks(spec, bn)
    row_offsets: torch.Tensor   # (gm,) int32 row_offsets


def fold_table(spec: EpitomeSpec) -> np.ndarray:
    """(m, c) table of the virtual rows that fold into each epitome row,
    ascending, c the most any row receives; the padding points at row M,
    which ``fold_rows`` makes a zero column."""
    return preimage_table(spec.row_index_map(), spec.m)


@functools.lru_cache(maxsize=None)
def spec_tables(spec: EpitomeSpec, bn: int, device: torch.device) -> SpecTables:
    """Copied to the device once per (spec, bn, device): a host-to-device
    copy of a numpy table waits for the stream, so doing it per call would
    stall the host on every layer."""
    def put(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)
    return SpecTables(fold_tables(spec, device).rows,
                      put(kernel_col_blocks(spec, bn)), put(spec.row_offsets()))


def fold_rows(x: torch.Tensor, spec: EpitomeSpec) -> torch.Tensor:
    """IFRT analogue: sum the virtual fan-in into epitome rows.

    Each epitome row gathers the virtual rows that sample it and sums them
    in float32, whatever x's dtype; a bfloat16 x gets its fold rounded once.
    A gather and a sum repeat bit for bit on the card, where a scatter-add
    (``index_add_``) adds with atomics in an order that changes from run to
    run: in float32 that moved one last bit now and then, enough to move a
    32-layer bf16 LM's logits by 0.4 between identical prefills."""
    return gather_sum(x, spec_tables(spec, spec.bn, x.device).fold, spec.m)


def epitome_matmul(x: torch.Tensor, E: torch.Tensor, spec: EpitomeSpec, *,
                   bk: Optional[int] = None, bn: Optional[int] = None) -> torch.Tensor:
    """y = x @ W(E) via the epitome-space kernel, in x's dtype: E is cast to
    it on every call, as the reference casts it.  Leading dims are free-form
    and flatten to (T, M) rows; bk/bn override the heuristic blocks; a bk
    that tiles m raggedly zero-pads the contraction dim (dot-neutral)."""
    *lead, M = x.shape
    bk = _pick_bk(spec.m) if bk is None else bk
    bn = spec.bn if bn is None else bn
    folded, E = _pad_contraction(fold_rows(x.reshape(-1, M), spec), E.to(x.dtype), bk)
    y = epitome_matmul_blocks(folded, E.contiguous(),
                              spec_tables(spec, bn, x.device).col_blocks, bn=bn)
    return y[:, :spec.N].reshape(*lead, spec.N)


_BT_BLOCKS = (256, 128, 64, 32, 16, 8)


def _pick_bt(T: int) -> int:
    """Row block for a T-row matmul: the largest block dividing T exactly,
    else the largest block not exceeding T (the caller pads T up to it)."""
    for bt in _BT_BLOCKS:
        if T % bt == 0:
            return bt
    for bt in _BT_BLOCKS:
        if bt <= T:
            return bt
    return _BT_BLOCKS[-1]     # T < 8: a single (padded) row block


def _pad_rows(x2: torch.Tensor, bt: Optional[int] = None) -> tuple:
    """Zero-pad the row dim of (T, m) up to a multiple of the row block, as
    the reference pads for its TPU grid.  Returns (padded, bt).  No wrapper
    here calls it: every kernel masks rows t >= T, and every plain version
    takes any T."""
    T = x2.shape[0]
    bt = _pick_bt(T) if bt is None else bt
    pad = (-T) % bt
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    return x2, bt


_BK_BLOCKS = (512, 256, 128, 64, 32, 16, 8)


def _pick_bk(m: int) -> int:
    """Contraction block for an m-row epitome: the largest block dividing m
    exactly, else the largest standard block not exceeding m (the caller
    zero-pads the contraction dim, ``_pad_contraction``)."""
    for bk in _BK_BLOCKS:
        if m % bk == 0:
            return bk
    for bk in _BK_BLOCKS:
        if bk <= m:
            return bk
    return m                  # m < 8: a single (tiny) block


def _pad_contraction(folded: torch.Tensor, w_rows: torch.Tensor, bk: int) -> tuple:
    """Zero-pad the contraction dim of (T, m) x (m, n) up to a bk multiple;
    the zero activation columns make the padded weight rows dot-neutral."""
    m = folded.shape[1]
    pad = (-m) % bk
    if pad:
        folded = F.pad(folded, (0, pad))
        w_rows = F.pad(w_rows, (0, 0, 0, pad))
    return folded, w_rows


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None,
         chunk: int = 64) -> tuple:
    """Chunked RWKV6 WKV.  r/k/v/logw: (B, S, H, K), logw <= 0; u: (H, K);
    state: (B, H, K, K) or None (zero).  Returns (o (B, S, H, K), final
    state), both float32, as ``ssm.rwkv_chunked`` computes them in float32;
    the caller casts o back.  r, k and v pass as they come (float32, or the
    LM's bfloat16, which the kernel reads directly); logw, u and the state
    are float32.  The call goes through ``WKV6``: one launch of kernel #4,
    and, where autograd records, the WKV backward kernel as its gradient."""
    f32 = lambda t: t.to(torch.float32).contiguous()
    return WKV6.apply(r.contiguous(), k.contiguous(), v.contiguous(), f32(logw),
                      f32(u), None if state is None else f32(state), chunk)


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
               A: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor] = None,
               chunk: int = 128) -> tuple:
    """Mamba's selective scan.  dt, x: (B, S, di); Bm, Cm: (B, S, ds); A:
    (di, ds); D: (di,); h0: (B, di, ds) or None (zero).  Returns (y (B, S,
    di), final state), both float32, y including D x; the caller casts y
    back.  dt, x, Bm and Cm pass in one dtype (float32, or the LM's
    bfloat16, which the kernel reads directly); A, D and the state are
    float32.  The call goes through ``MambaScan``: one launch of the scan
    kernel for a prefill or a decode step alike."""
    f32 = lambda t: t.to(torch.float32).contiguous()
    return MambaScan.apply(dt.contiguous(), x.contiguous(), Bm.contiguous(), Cm.contiguous(),
                           f32(A), f32(D), None if h0 is None else f32(h0), chunk)


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                 zeros: torch.Tensor) -> torch.Tensor:
    """x @ ((q + z) * s) with one (scale, zero) per 256 x 256 tile of the
    (M, N) int8 codes.  Leading dims of x are free-form and flatten to
    (T, M) rows."""
    *lead, M = x.shape
    y = _quant_matmul(x.reshape(-1, M).contiguous(), q, scales, zeros)
    return y.reshape(*lead, q.shape[1])


# ---------------------------------------------------------------------------
# Fused quantized-epitome path (the paper's flagship configuration)
# ---------------------------------------------------------------------------
class PackedEpitome(NamedTuple):
    """An epitome packed for the fused kernel: int8 codes + per-block
    (scale, zero).  Pack once (at load), reuse every forward."""
    q: torch.Tensor          # (m, n) int8
    scales: torch.Tensor     # (ceil(m/bk), n/bn) float32
    zeros: torch.Tensor      # (ceil(m/bk), n/bn) float32
    bk: int
    bn: int


def _pick_bk_quant(m: int, tile: int) -> int:
    """Pack row block: never wider than the quantizer's crossbar tile, so
    each block nests inside one scale tile; prime/odd m takes the largest
    standard block not exceeding min(tile, m)."""
    for bk in _BK_BLOCKS[1:]:
        if bk <= tile and m % bk == 0:
            return bk
    for bk in _BK_BLOCKS[1:]:
        if bk <= min(tile, m):
            return bk
    return m


def pack_blocks(spec: EpitomeSpec, qcfg: QuantConfig,
                blocks: Optional[tuple] = None) -> tuple:
    """The (bk, bn) block a pack of (spec, qcfg) uses; ``blocks`` is an
    autotuned (bt, bk, bn) triple overriding the heuristic."""
    if blocks is not None:
        bt, bk, bn = blocks
        assert col_blocks_splittable(spec, bn), (spec, bn)
        return bk, bn
    return _pick_bk_quant(spec.m, qcfg.tile), spec.bn


def pack_epitome(E: torch.Tensor, spec: EpitomeSpec, qcfg: QuantConfig,
                 blocks: Optional[tuple] = None) -> PackedEpitome:
    """Quantize an epitome into the kernel's storage layout: int8 codes and
    a float32 (scale, zero) per block.  A bf16 epitome's scales and zeros
    are computed in bf16, as the reference's are, then widened (exactly):
    the reference's kernel body widens them to float32 too."""
    bk, bn = pack_blocks(spec, qcfg, blocks)
    q, scales, zeros = quantize_epitome_packed(E, spec, qcfg, (bk, bn))
    return PackedEpitome(q, scales.float(), zeros.float(), bk, bn)


def quant_epitome_matmul(x: torch.Tensor, E: Optional[torch.Tensor],
                         spec: EpitomeSpec, qcfg: Optional[QuantConfig] = None,
                         *, packed: Optional[PackedEpitome] = None,
                         fused_fold: bool = False) -> torch.Tensor:
    """y = x @ W(deq(Q(E))) via the fused int8-epitome kernels.

    Pass ``packed`` (from pack_epitome) to skip re-quantizing per call;
    otherwise E is packed on the fly.  ``fused_fold=True`` runs the fold
    inside the kernel.  A ragged m (prime or odd) goes in as it is: the
    kernels mask the last pack block's missing rows."""
    if packed is None:
        assert E is not None and qcfg is not None
        packed = pack_epitome(E, spec, qcfg)
    *lead, M = x.shape
    x2 = x.reshape(-1, M)
    tables = spec_tables(spec, packed.bn, x.device)
    kw = dict(bk=packed.bk, bn=packed.bn)
    if fused_fold:
        y = quant_epitome_matmul_fused_fold(
            x2.to(torch.float32).contiguous(), packed.q, packed.scales, packed.zeros,
            tables.col_blocks, tables.row_offsets, bm=spec.bm, fold=tables.fold,
            **kw).to(x.dtype)
    else:
        y = quant_epitome_matmul_blocks(fold_rows(x2, spec).contiguous(), packed.q,
                                        packed.scales, packed.zeros, tables.col_blocks, **kw)
    return y[:, :spec.N].reshape(*lead, spec.N)
