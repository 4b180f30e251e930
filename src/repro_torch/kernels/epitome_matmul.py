"""Epitome-space blocked matmul with output indirection (float32).

Computes  y[:, j*bn:(j+1)*bn] = x_folded @ E[:, cb[j]*bn:(cb[j]+1)*bn]
for every output column block j, where ``cb`` is the static column-block
table derived from the EpitomeSpec (the paper's OFAT).  Repeated entries
are output channel wrapping.

For CUDA tensors this launches the kernel of ``csrc/epitome_matmul.cu``;
for CPU tensors it runs the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import epitome_matmul_blocks_ref


def epitome_matmul_blocks(x_folded: torch.Tensor, E: torch.Tensor,
                          col_blocks, *, bn: int) -> torch.Tensor:
    """x_folded: (T, m); E: (m, n); col_blocks: (gn,) int32 block indices
    into E's column blocks of width bn (a tensor on x's device for the
    kernel).  Returns (T, gn*bn)."""
    if x_folded.device.type == "cpu":
        return epitome_matmul_blocks_ref(x_folded, E, col_blocks, bn)
    name = "epitome_matmul_blocks"
    _build.require_cuda(name, x_folded, x_folded=x_folded, E=E, col_blocks=col_blocks)
    _build.require_dtype(name, "x_folded", x_folded, torch.float32)
    _build.require_dtype(name, "E", E, torch.float32)
    _build.require_dtype(name, "col_blocks", col_blocks, torch.int32)
    T, m = x_folded.shape
    m2, n = E.shape
    gn = col_blocks.shape[0]
    if m != m2 or n % bn:
        raise ValueError(f"{name}: x_folded {tuple(x_folded.shape)} @ E "
                         f"{tuple(E.shape)} with bn={bn}")
    _build.require_rows(name, T)
    y = torch.empty((T, gn * bn), device=x_folded.device, dtype=torch.float32)
    with torch.cuda.device(x_folded.device):
        rc = _build.library("epitome_matmul").epitome_matmul_blocks_launch(
            x_folded.data_ptr(), E.data_ptr(), col_blocks.data_ptr(),
            y.data_ptr(), T, m, n, gn, bn, _build.stream_of(x_folded))
    _build.check_launch(rc, name)
    epitome_matmul_blocks.launches += 1
    return y


epitome_matmul_blocks.launches = 0
