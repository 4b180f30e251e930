"""Epitome-space blocked matmul with output indirection (float32 or bf16).

Computes  y[:, j*bn:(j+1)*bn] = x_folded @ E[:, cb[j]*bn:(cb[j]+1)*bn]
for every output column block j, where ``cb`` is the static column-block
table derived from the EpitomeSpec (the paper's OFAT).  Repeated entries
are output channel wrapping.

For CUDA tensors this launches the kernel of ``csrc/epitome_matmul.cu``, on
the tensor cores (``csrc/epitome_fp_mma.cuh``: 3xTF32 for float32, one bf16
pass for bf16), the contraction split over blocks where too few output
tiles would fill the card; for CPU tensors it runs the plain version in
``ref.py``.
"""
from __future__ import annotations

import torch

from . import _build
from .quant_epitome_matmul import _ptr, _split_buffers, split_rows
from .ref import epitome_matmul_blocks_ref


def epitome_matmul_blocks(x_folded: torch.Tensor, E: torch.Tensor,
                          col_blocks, *, bn: int) -> torch.Tensor:
    """x_folded: (T, m) float32 or bfloat16; E: (m, n) in x_folded's dtype;
    col_blocks: (gn,) int32 block indices into E's column blocks of width bn
    (a tensor on x's device for the kernel).  Returns (T, gn*bn) in
    x_folded's dtype: the sum is float32 and a bfloat16 result is rounded
    once, as in the TPU kernel."""
    if x_folded.device.type == "cpu":
        return epitome_matmul_blocks_ref(x_folded, E, col_blocks, bn)
    name = "epitome_matmul_blocks"
    _build.require_cuda(name, x_folded, x_folded=x_folded, E=E, col_blocks=col_blocks)
    _build.require_dtype(name, "x_folded", x_folded, torch.float32, torch.bfloat16)
    if E.dtype != x_folded.dtype:
        raise TypeError(f"{name}: E must have x_folded's dtype {x_folded.dtype}, "
                        f"got {E.dtype}")
    _build.require_dtype(name, "col_blocks", col_blocks, torch.int32)
    T, m = x_folded.shape
    m2, n = E.shape
    gn = col_blocks.shape[0]
    if m != m2 or n % bn:
        raise ValueError(f"{name}: x_folded {tuple(x_folded.shape)} @ E "
                         f"{tuple(E.shape)} with bn={bn}")
    _build.require_rows(name, T)
    dev = x_folded.device
    y = torch.empty((T, gn * bn), device=dev, dtype=x_folded.dtype)
    rows = split_rows(T, m, gn, bn, decode=False)
    scratch, counters = _split_buffers(dev, T, m, gn, bn, rows)
    lib = _build.library("epitome_matmul")
    launch = (lib.epitome_matmul_blocks_launch if x_folded.dtype == torch.float32
              else lib.epitome_matmul_blocks_bf16_launch)
    with torch.cuda.device(dev):
        rc = launch(x_folded.data_ptr(), E.data_ptr(), col_blocks.data_ptr(), y.data_ptr(),
                    _ptr(scratch), _ptr(counters), T, m, n, gn, bn, rows,
                    _build.stream_of(x_folded))
    _build.check_launch(rc, name)
    epitome_matmul_blocks.launches += 1
    return y


epitome_matmul_blocks.launches = 0
