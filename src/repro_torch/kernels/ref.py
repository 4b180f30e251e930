"""Plain PyTorch versions of the three epitome matmul kernels, shape for
shape the oracles of ``repro.kernels.ref``.  The kernel wrappers run these
for tensors on the CPU; on the card they are what each kernel is held
against."""
from __future__ import annotations

import torch

from ..core.quant import dequantize_packed


def _col_block_list(col_blocks) -> list:
    return [int(c) for c in torch.as_tensor(col_blocks).tolist()]


def epitome_matmul_blocks_ref(x_folded: torch.Tensor, E: torch.Tensor,
                              col_blocks, bn: int) -> torch.Tensor:
    """y block j = x_folded @ E[:, cb[j]*bn : (cb[j]+1)*bn]."""
    cols = [x_folded @ E[:, cb * bn:(cb + 1) * bn]
            for cb in _col_block_list(col_blocks)]
    return torch.cat(cols, dim=-1).to(x_folded.dtype)


def quant_epitome_matmul_blocks_ref(x_folded: torch.Tensor, q: torch.Tensor,
                                    scales: torch.Tensor, zeros: torch.Tensor,
                                    col_blocks, bk: int, bn: int) -> torch.Tensor:
    """Dequantize the whole int8 epitome per (bk x bn) block, then the same
    column-block-indirected matmul as the fp version."""
    E = dequantize_packed(q, scales, zeros, (bk, bn))
    return epitome_matmul_blocks_ref(x_folded.to(torch.float32), E,
                                     col_blocks, bn).to(x_folded.dtype)


def fold_blocks_ref(x: torch.Tensor, row_offsets, bm: int, m: int) -> torch.Tensor:
    """Fold the unfolded activation x (T, M) into epitome-row space (T, m):
    virtual row block i (rows [i*bm, (i+1)*bm), the last one possibly short)
    adds into epitome rows [ro[i], ro[i]+bm), in ascending i."""
    T, M = x.shape
    folded = x.new_zeros(T, m)
    for i, off in enumerate(_col_block_list(row_offsets)):
        lo, hi = i * bm, min(M, (i + 1) * bm)
        if lo < hi:
            folded[:, off:off + hi - lo] += x[:, lo:hi]
    return folded


def quant_epitome_matmul_fused_fold_ref(x: torch.Tensor, q: torch.Tensor,
                                        scales: torch.Tensor, zeros: torch.Tensor,
                                        col_blocks, row_offsets, *, bm: int,
                                        bk: int, bn: int) -> torch.Tensor:
    """The fused-fold kernel's function: the fold of ``fold_blocks_ref``
    followed by the quantized block matmul.  x is the unfolded (T, M)
    activation; q's rows may be zero-padded past the folded width."""
    folded = fold_blocks_ref(x.to(torch.float32), row_offsets, bm, q.shape[0])
    return quant_epitome_matmul_blocks_ref(folded, q, scales, zeros,
                                           col_blocks, bk, bn)
