"""Fused quantized-epitome matmul (EPIM's flagship path), two kernels:

``quant_epitome_matmul_blocks``:
    y[:, j*bn:(j+1)*bn] = x_folded @ ((Q_blk + z[k, cb[j]]) * s[k, cb[j]])
  with Q the (m, n) int8 codes and one float32 (scale, zero) per (bk x bn)
  pack block, dequantized inside the kernel.

``quant_epitome_matmul_fused_fold``:
  the same product from the *unfolded* (T, M) activation and the row-offset
  table: the fold into epitome rows (the IFRT analogue, ops.fold_rows) runs
  inside the kernel, so the folded activation never goes through device
  memory.

For CUDA tensors these launch the kernels of ``csrc/quant_epitome_matmul.cu``
(and, for a bfloat16 activation, ``csrc/quant_epitome_matmul_bf16.cu``); for
CPU tensors they run the plain versions in ``ref.py``.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import (quant_epitome_matmul_blocks_ref,
                  quant_epitome_matmul_fused_fold_ref)


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
    y = torch.empty((T, gn * bn), device=x_folded.device, dtype=x_folded.dtype)
    launch = (_build.library("quant_epitome_matmul").quant_epitome_matmul_blocks_launch
              if x_folded.dtype == torch.float32 else
              _build.library("quant_epitome_matmul_bf16").quant_epitome_matmul_blocks_bf16_launch)
    with torch.cuda.device(x_folded.device):
        rc = launch(
            x_folded.data_ptr(), q.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
            col_blocks.data_ptr(), y.data_ptr(), T, m, n, gn, bn, bk,
            scales.shape[1], _build.stream_of(x_folded))
    _build.check_launch(rc, name)
    quant_epitome_matmul_blocks.launches += 1
    return y


quant_epitome_matmul_blocks.launches = 0


def quant_epitome_matmul_fused_fold(x: torch.Tensor, q: torch.Tensor,
                                    scales: torch.Tensor, zeros: torch.Tensor,
                                    col_blocks, row_offsets, *, bm: int,
                                    bk: int, bn: int) -> torch.Tensor:
    """x: the (T, M) *unfolded* activation, virtual row block i being rows
    [i*bm, (i+1)*bm); row_offsets: (gm,) int32 epitome row offset of each
    virtual row block (spec.row_offsets()), gm = ceil(M / bm); q/scales/
    zeros as in quant_epitome_matmul_blocks, q's rows at least the folded
    width.  Returns (T, gn*bn) float32."""
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
    _build.require_rows(name, T)
    y = torch.empty((T, gn * bn), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = _build.library("quant_epitome_matmul").quant_epitome_matmul_fused_fold_launch(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
            col_blocks.data_ptr(), row_offsets.data_ptr(), y.data_ptr(),
            T, M, m, n, gn, gm, bm, bn, bk, scales.shape[1], _build.stream_of(x))
    _build.check_launch(rc, name)
    quant_epitome_matmul_fused_fold.launches += 1
    return y


quant_epitome_matmul_fused_fold.launches = 0
