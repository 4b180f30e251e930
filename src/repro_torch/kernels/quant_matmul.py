"""Dense int8 dequant matmul with per-crossbar-tile scales (EPIM §4.2):

    y = x @ ((q + z[k/256, j/256]) * s[k/256, j/256])

q is an (M, N) int8 code matrix with one float32 (scale, zero) per
256 x 256 tile, exactly one crossbar of the PIM mapping; M and N are
multiples of 256.  The sum is float32 and y is in x's dtype (float32 or
bfloat16).

For CUDA tensors this launches the kernel of ``csrc/quant_matmul.cu``:
kernel #1's main loop (``csrc/epitome_mma.cuh``) with an identity column
table, tensor-core products at prefill rows and split-K streaming at decode
rows (T <= 32), with the split picks and scratch of kernel #1's wrapper.
For CPU tensors it runs the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from . import _build
from .quant_epitome_matmul import _ptr, _split_buffers, split_rows
from .ref import quant_matmul_ref

TILE = 256      # one (scale, zero) per TILE x TILE block of codes
_identity = {}  # (device, N / TILE) -> int32 arange: output block j reads block j


def _identity_blocks(device: torch.device, gn: int) -> torch.Tensor:
    key = (device, gn)
    if key not in _identity:
        _identity[key] = torch.arange(gn, dtype=torch.int32, device=device)
    return _identity[key]


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                 zeros: torch.Tensor) -> torch.Tensor:
    """x: (T, M) float32 or bfloat16; q: (M, N) int8; scales/zeros:
    (M/256, N/256) float32.  Returns (T, N) in x's dtype."""
    if x.device.type == "cpu":
        return quant_matmul_ref(x, q, scales, zeros, TILE)
    name = "quant_matmul"
    _build.require_cuda(name, x, x=x, q=q, scales=scales, zeros=zeros)
    _build.require_dtype(name, "x", x, torch.float32, torch.bfloat16)
    _build.require_dtype(name, "q", q, torch.int8)
    _build.require_dtype(name, "scales", scales, torch.float32)
    _build.require_dtype(name, "zeros", zeros, torch.float32)
    T, M = x.shape
    if q.shape[0] != M or M % TILE or q.shape[1] % TILE:
        raise ValueError(f"{name}: x (T, {M}) and codes {tuple(q.shape)} need "
                         f"matching M, and M and N multiples of {TILE}")
    N = q.shape[1]
    grid = (M // TILE, N // TILE)
    if tuple(scales.shape) != grid or tuple(zeros.shape) != grid:
        raise ValueError(f"{name}: codes {tuple(q.shape)} need scales/zeros of "
                         f"shape {grid}, got {tuple(scales.shape)} / "
                         f"{tuple(zeros.shape)}")
    _build.require_rows(name, T)
    y = torch.empty((T, N), device=x.device, dtype=x.dtype)
    gn = N // TILE
    rows = split_rows(T, M, gn, TILE)
    scratch, counters = _split_buffers(x.device, T, M, gn, TILE, rows)
    lib = _build.library("quant_matmul")
    launch = (lib.quant_matmul_launch if x.dtype == torch.float32
              else lib.quant_matmul_bf16_launch)
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), q.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                    _identity_blocks(x.device, gn).data_ptr(), y.data_ptr(), _ptr(scratch),
                    _ptr(counters), T, M, N, rows, _build.stream_of(x))
    _build.check_launch(rc, name)
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0
