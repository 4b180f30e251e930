"""Chunked RWKV6 (Finch) WKV with data-dependent decay and a carried state.

Per (batch, head), over chunks of L tokens with a K x K float32 state S:
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t
evaluated in the chunked form of ``repro.models.ssm.rwkv_chunked`` (all
decay exponents relative and non-positive).  With ``h0=None`` the state
starts at zero, which is ``repro.kernels.wkv6.wkv6_chunked``.

For CUDA tensors this launches the kernel of ``csrc/wkv6.cu`` (the chunk
products on the tensor cores, 3xTF32), which reads r, k and v as float32 or
as bfloat16, the LM's projections as they come; for CPU tensors it runs the
plain version in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .ref import wkv6_chunked_ref

MAX_K = MAX_CHUNK = 64      # the kernel's shared-memory tiles (csrc/wkv6.cu)
RKV_DTYPES = (torch.float32, torch.bfloat16)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor,
                 h0: Optional[torch.Tensor] = None, *,
                 chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v: (B, S, H, K), float32 or bfloat16, one dtype; logw: (B, S, H,
    K) float32, <= 0; u: (H, K) float32; h0: (B, H, K, K) float32, or None
    for a zero state.  Returns (o (B, S, H, K), hT (B, H, K, K)), both
    float32; chunks are min(chunk, S) tokens."""
    if r.device.type == "cpu":
        return wkv6_chunked_ref(r, k, v, logw, u, h0, chunk=chunk)
    name = "wkv6_chunked"
    state = {} if h0 is None else {"h0": h0}
    _build.require_cuda(name, r, r=r, k=k, v=v, logw=logw, u=u, **state)
    _build.require_dtype(name, "r", r, *RKV_DTYPES)
    for arg, t in dict(k=k, v=v).items():
        if t.dtype != r.dtype:
            raise TypeError(f"{name}: r, k and v must share one dtype, got r {r.dtype} "
                            f"and {arg} {t.dtype}")
    for arg, t in dict(logw=logw, u=u, **state).items():
        _build.require_dtype(name, arg, t, torch.float32)
    B, S, H, K = r.shape
    L = max(1, min(chunk, S))
    if k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape \
            or u.shape != (H, K) or (h0 is not None and h0.shape != (B, H, K, K)):
        raise ValueError(f"{name}: r/k/v/logw {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(logw.shape)}; u {tuple(u.shape)}; "
                         f"h0 {None if h0 is None else tuple(h0.shape)}")
    if K > MAX_K or L > MAX_CHUNK:
        raise ValueError(f"{name}: head size {K} and chunk {L} must be at most "
                         f"{MAX_K} and {MAX_CHUNK}")
    o = torch.empty(r.shape, device=r.device, dtype=torch.float32)
    hT = torch.empty((B, H, K, K), device=r.device, dtype=torch.float32)
    with torch.cuda.device(r.device):
        rc = _build.library("wkv6").wkv6_chunked_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            None if h0 is None else h0.data_ptr(), o.data_ptr(), hT.data_ptr(),
            B, S, H, K, L, int(r.dtype == torch.bfloat16), _build.stream_of(r))
    _build.check_launch(rc, name)
    wkv6_chunked.launches += 1
    return o, hT


wkv6_chunked.launches = 0
