"""Fused quantized-epitome matmul (EPIM's flagship path), two kernels:

``quant_epitome_matmul_blocks``:
    y[:, j*bn:(j+1)*bn] = x_folded @ ((Q_blk + z[k, cb[j]]) * s[k, cb[j]])
  with Q the (m, n) int8 codes and one float32 (scale, zero) per (bk x bn)
  pack block, dequantized inside the kernel.

``quant_epitome_matmul_fused_fold``:
  the same product from the *unfolded* (T, M) activation: the fold into
  epitome rows (the IFRT analogue, ops.fold_rows) runs inside the kernel,
  so the folded activation never goes through device memory.

For CUDA tensors these launch the kernels of ``csrc/quant_epitome_matmul.cu``
(and, for a bfloat16 activation, ``csrc/quant_epitome_matmul_bf16.cu``), both
on the main loop of ``csrc/epitome_mma.cuh``: tensor-core products on the
int8 codes at prefill rows, and at decode rows (T <= DECODE_ROWS, kernel #1)
a SIMT loop that streams the codes.  Where too few output tiles would fill
the card, the contraction is split over blocks, whose partials are summed
in a fixed order inside the same launch.  For CPU tensors they run the plain
versions in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import (quant_epitome_matmul_blocks_ref,
                  quant_epitome_matmul_fused_fold_ref)

# the tiles of csrc/epitome_mma.cuh
DECODE_ROWS = 32        # T up to this takes kernel #1's decode loop (DEC_MAX_T)
DECODE_SPLITS = (128, 64)   # contraction rows per decode block, the larger first
_DECODE_COLS = 128      # columns per decode block
_BM, _KS = 128, 32      # rows per tensor-core tile, contraction rows per step
_SMS = 132              # the H100's SMs
_counters = {}          # (device, stream) -> int32 ticket counters, 0 between launches


def split_rows(T: int, m: int, gn: int, bn: int, decode: bool = True) -> int:
    """Contraction rows per split, 0 for none.  The decode loop (T <=
    DECODE_ROWS, where ``decode``) always splits: 128 rows a block where
    that still gives two waves of blocks, else 64, whatever T, so that a
    row sums in one order at every T the loop takes (a row of a T-row call
    is the same row of a 1-row call, bit for bit; at T > DECODE_ROWS the
    tensor-core loop sums in another order, by design).  The tensor-core loop splits only where its
    output tiles fill less than a wave: for longer T into enough splits for
    two waves with at least 16 steps each (a split writes and reads back a
    float32 partial of its whole tile); at T <= DECODE_ROWS (kernels #2 and
    #3, whose one row tile is mostly masked) into one wave of splits, each
    as short as that makes it (ResNet-50's fc at T = 32: 16 splits of 4
    steps)."""
    if decode and T <= DECODE_ROWS:
        tiles = gn * -(-bn // _DECODE_COLS)
        return next((r for r in DECODE_SPLITS if -(-m // r) * tiles >= 2 * _SMS),
                    DECODE_SPLITS[-1])
    tiles = gn * -(-bn // (128 if bn >= 128 else 64)) * -(-T // _BM)
    steps = -(-m // _KS)
    if T <= DECODE_ROWS:
        splits = min(_SMS // tiles, steps)
    else:
        splits = min(-(-2 * _SMS // tiles), steps // 16)
    if tiles >= _SMS or splits < 2:
        return 0
    return -(-steps // splits) * _KS


def _split_buffers(dev, T: int, m: int, gn: int, bn: int, rows: int) -> tuple:
    """The split partials' scratch and the ticket counters, or (None, None);
    held by the caller until the launch is queued."""
    if not rows or rows >= m:
        return None, None
    scratch = torch.empty(-(-m // rows) * T * gn * bn, device=dev, dtype=torch.float32)
    return scratch, _ticket_counters(dev, gn * -(-bn // 64) * -(-T // _BM))


def _ticket_counters(device: torch.device, n: int) -> torch.Tensor:
    """One buffer per (device, stream), zeroed when it is made on that
    stream and grown on demand; each launch's last block per output tile
    sets its counter back to 0.  The launches of one stream take them in
    turn, and launches on two streams never share them.  A CUDA graph keeps
    the buffer of the stream it was captured on: replay it on that stream's
    order, not beside eager launches there."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_codes(name, ref, q, scales, zeros, col_blocks, bk, bn, x_dtypes, **extra):
    _build.require_cuda(name, ref, x=ref, q=q, scales=scales, zeros=zeros,
                        col_blocks=col_blocks, **extra)
    _build.require_dtype(name, "x", ref, *x_dtypes)
    _build.require_dtype(name, "q", q, torch.int8)
    _build.require_dtype(name, "scales", scales, torch.float32)
    _build.require_dtype(name, "zeros", zeros, torch.float32)
    _build.require_dtype(name, "col_blocks", col_blocks, torch.int32)
    m, n = q.shape
    if n % bn or scales.shape != (-(-m // bk), n // bn) or zeros.shape != scales.shape:
        raise ValueError(f"{name}: codes {tuple(q.shape)} with (bk, bn)=({bk}, {bn}) "
                         f"need scales/zeros of shape {(-(-m // bk), n // bn)}, got "
                         f"{tuple(scales.shape)} / {tuple(zeros.shape)}")
    if bk % 8 and bk < m:
        raise ValueError(f"{name}: pack bk={bk} must be a multiple of 8 or cover "
                         f"all {m} rows")


def quant_epitome_matmul_blocks(x_folded: torch.Tensor, q: torch.Tensor,
                                scales: torch.Tensor, zeros: torch.Tensor,
                                col_blocks, *, bk: int, bn: int) -> torch.Tensor:
    """x_folded: (T, m) float32 or bfloat16; q: (m, n) int8 codes;
    scales/zeros: (ceil(m/bk), n/bn) float32 per pack block; col_blocks:
    (gn,) int32 (a tensor on x's device for the kernel).  Returns
    (T, gn*bn) in x_folded's dtype: the sum is float32 either way and a
    bfloat16 result is rounded once, as in the TPU kernel."""
    if x_folded.device.type == "cpu":
        return quant_epitome_matmul_blocks_ref(x_folded, q, scales, zeros,
                                               col_blocks, bk, bn)
    name = "quant_epitome_matmul_blocks"
    _check_codes(name, x_folded, q, scales, zeros, col_blocks, bk, bn,
                 (torch.float32, torch.bfloat16))
    T, m = x_folded.shape
    n = q.shape[1]
    gn = col_blocks.shape[0]
    if q.shape[0] != m:
        raise ValueError(f"{name}: x_folded has {m} columns, q has {q.shape[0]} rows")
    _build.require_rows(name, T)
    dev = x_folded.device
    y = torch.empty((T, gn * bn), device=dev, dtype=x_folded.dtype)
    rows = split_rows(T, m, gn, bn)
    scratch, counters = _split_buffers(dev, T, m, gn, bn, rows)
    launch = (_build.library("quant_epitome_matmul").quant_epitome_matmul_blocks_launch
              if x_folded.dtype == torch.float32 else
              _build.library("quant_epitome_matmul_bf16").quant_epitome_matmul_blocks_bf16_launch)
    with torch.cuda.device(dev):
        rc = launch(
            x_folded.data_ptr(), q.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
            col_blocks.data_ptr(), y.data_ptr(), _ptr(scratch), _ptr(counters),
            T, m, n, gn, bn, bk, scales.shape[1], rows, _build.stream_of(x_folded))
    _build.check_launch(rc, name)
    quant_epitome_matmul_blocks.launches += 1
    return y


quant_epitome_matmul_blocks.launches = 0


def quant_epitome_matmul_fused_fold(x: torch.Tensor, q: torch.Tensor,
                                    scales: torch.Tensor, zeros: torch.Tensor,
                                    col_blocks, row_offsets, *, bm: int,
                                    bk: int, bn: int,
                                    fold: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: the (T, M) *unfolded* activation, virtual row block i being rows
    [i*bm, (i+1)*bm); row_offsets: (gm,) int32 epitome row offset of each
    virtual row block (spec.row_offsets()), gm = ceil(M / bm); q/scales/
    zeros as in quant_epitome_matmul_blocks, q's rows the folded width m.
    The kernel folds from ``fold``, the spec's inverse table
    (``ops.SpecTables.fold``: (c*m,) int64, the virtual rows of each epitome
    row in ascending order, column by column, padded with M); the plain
    version from row_offsets.  Returns (T, gn*bn) float32."""
    if x.device.type == "cpu":
        return quant_epitome_matmul_fused_fold_ref(
            x, q, scales, zeros, col_blocks, row_offsets, bm=bm, bk=bk, bn=bn)
    name = "quant_epitome_matmul_fused_fold"
    _check_codes(name, x, q, scales, zeros, col_blocks, bk, bn, (torch.float32,),
                 row_offsets=row_offsets)
    _build.require_dtype(name, "row_offsets", row_offsets, torch.int32)
    T, M = x.shape
    m, n = q.shape
    gn = col_blocks.shape[0]
    gm = row_offsets.shape[0]
    if gm != -(-M // bm):
        raise ValueError(f"{name}: {gm} row offsets for M={M}, bm={bm}")
    if fold is None:
        raise ValueError(f"{name}: the kernel folds from the inverse table; pass "
                         f"fold=ops.spec_tables(spec, bn, device).fold")
    _build.require_cuda(name, x, fold=fold)
    _build.require_dtype(name, "fold", fold, torch.int64)
    if fold.dim() != 1 or fold.numel() % m:
        raise ValueError(f"{name}: fold table of {fold.numel()} entries for m={m}")
    _build.require_rows(name, T)
    y = torch.empty((T, gn * bn), device=x.device, dtype=torch.float32)
    rows = split_rows(T, m, gn, bn, decode=False)
    scratch, counters = _split_buffers(x.device, T, m, gn, bn, rows)
    with torch.cuda.device(x.device):
        rc = _build.library("quant_epitome_matmul").quant_epitome_matmul_fused_fold_launch(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
            col_blocks.data_ptr(), fold.data_ptr(), y.data_ptr(), _ptr(scratch),
            _ptr(counters), T, M, m, n, gn, bn, bk, scales.shape[1], fold.numel() // m,
            rows, _build.stream_of(x))
    _build.check_launch(rc, name)
    quant_epitome_matmul_fused_fold.launches += 1
    return y


quant_epitome_matmul_fused_fold.launches = 0
