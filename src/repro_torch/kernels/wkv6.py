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

``wkv6_chunked_bwd`` is its gradient (``csrc/wkv6_bwd.cu`` on the card, the
same chunked form run backward on the tensor cores, with one stored state a
chunk of 64 tokens; ``ref.wkv6_chunked_bwd_ref`` on the CPU), and ``WKV6``
the autograd function that pairs the two, through which the LM trains.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, cost
from .ref import wkv6_chunked_bwd_ref, wkv6_chunked_ref

MAX_K = MAX_CHUNK = 64      # the kernel's shared-memory tiles (csrc/wkv6.cu)
RKV_DTYPES = (torch.float32, torch.bfloat16)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor,
                 h0: Optional[torch.Tensor] = None, *,
                 chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v: (B, S, H, K), float32 or bfloat16, one dtype; logw: (B, S, H,
    K) float32, <= 0; u: (H, K) float32; h0: (B, H, K, K) float32, or None
    for a zero state.  Returns (o (B, S, H, K), hT (B, H, K, K)), both
    float32; chunks are min(chunk, S) tokens.  A fake r takes the
    shape-only branch (``cost.shape_only``)."""
    if cost.shape_only(r):
        B, S, H, K = r.shape
        flops, products = cost.wkv6_ops(B, S, H, K, max(1, min(chunk, S)))
        cost.record(cost.WKV, cost.wkv6_bytes(B, S, H, K, r.element_size(), h0 is not None),
                    flops, cost.dtype_name(r), products)
        return (r.new_empty(r.shape, dtype=torch.float32),
                r.new_empty((B, H, K, K), dtype=torch.float32))
    if r.device.type == "cpu":
        return wkv6_chunked_ref(r, k, v, logw, u, h0, chunk=chunk)
    name = "wkv6_chunked"
    state = {} if h0 is None else {"h0": h0}
    _check(name, r, k, v, logw, u, state)
    B, S, H, K = r.shape
    L = max(1, min(chunk, S))
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


def _check(name: str, r, k, v, logw, u, state: dict, **more) -> None:
    """Device, contiguity, dtypes and shapes of the WKV's arguments:
    ``state`` and ``more`` hold the (B, H, K, K) float32 states and the
    (B, S, H, K) float32 gradients that are given."""
    _build.require_cuda(name, r, r=r, k=k, v=v, logw=logw, u=u, **state, **more)
    _build.require_dtype(name, "r", r, *RKV_DTYPES)
    for arg, t in dict(k=k, v=v).items():
        if t.dtype != r.dtype:
            raise TypeError(f"{name}: r, k and v must share one dtype, got r {r.dtype} "
                            f"and {arg} {t.dtype}")
    for arg, t in dict(logw=logw, u=u, **state, **more).items():
        _build.require_dtype(name, arg, t, torch.float32)
    B, S, H, K = r.shape
    if any(t.shape != r.shape for t in (k, v, logw, *more.values())) \
            or u.shape != (H, K) or any(t.shape != (B, H, K, K) for t in state.values()):
        shapes = {a: tuple(t.shape) for a, t in dict(r=r, k=k, v=v, logw=logw, u=u,
                                                     **state, **more).items()}
        raise ValueError(f"{name}: shapes {shapes}")


def wkv6_chunked_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, h0: Optional[torch.Tensor],
                     do: torch.Tensor, dhT: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``wkv6_chunked``'s recurrence: its arguments as they
    went in (h0 None for a zero state), ``do`` (B, S, H, K) float32 the
    gradient of o and ``dhT`` (B, H, K, K) float32 that of the final state
    (None: zero).  Returns (dr, dk, dv, dlogw, du, dh0), all float32.  The
    gradient is that of the exact token recurrence (``ref.
    wkv6_chunked_bwd_ref``), whatever the chunk of the forward.  A fake r
    takes the shape-only branch (``cost.shape_only``)."""
    if cost.shape_only(r):
        B, S, H, K = r.shape
        cost.record(cost.WKV_BWD, cost.wkv_bwd_bytes(B, S, H, K, r.element_size(),
                                                     h0 is not None, dhT is not None),
                    cost.wkv_bwd_ops(B, S, H, K), cost.dtype_name(r),
                    cost.wkv_bwd_chunked_ops(B, S, H, K))
        f32 = lambda *s: r.new_empty(s, dtype=torch.float32)
        return (f32(*r.shape), f32(*r.shape), f32(*r.shape), f32(*r.shape), f32(H, K),
                f32(B, H, K, K))
    if r.device.type == "cpu":
        return wkv6_chunked_bwd_ref(r, k, v, logw, u, h0, do, dhT)
    name = "wkv6_chunked_bwd"
    state = {a: t for a, t in dict(h0=h0, dhT=dhT).items() if t is not None}
    _check(name, r, k, v, logw, u, state, do=do)
    B, S, H, K = r.shape
    if K > MAX_K:
        raise ValueError(f"{name}: head size {K} must be at most {MAX_K}")
    f32 = dict(device=r.device, dtype=torch.float32)
    dr, dk, dv, dlogw = (torch.empty(r.shape, **f32) for _ in range(4))
    du, dh0 = torch.empty((H, K), **f32), torch.empty((B, H, K, K), **f32)
    du_part = torch.empty((B, H, K), **f32)
    lib = _build.library("wkv6_bwd")
    floats = ctypes.c_longlong()
    _build.check_launch(lib.wkv6_chunked_bwd_scratch(B, S, H, ctypes.byref(floats)), name)
    ckpt = torch.empty((floats.value,), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(r.device):
        rc = lib.wkv6_chunked_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            ptr(h0), do.data_ptr(), ptr(dhT), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dlogw.data_ptr(), du_part.data_ptr(), du.data_ptr(), dh0.data_ptr(),
            ckpt.data_ptr(), B, S, H, K, int(r.dtype == torch.bfloat16), _build.stream_of(r))
    _build.check_launch(rc, name)
    wkv6_chunked_bwd.launches += 1
    return dr, dk, dv, dlogw, du, dh0


wkv6_chunked_bwd.launches = 0


class WKV6(torch.autograd.Function):
    """``wkv6_chunked`` with its gradient: forward kernel #4 (its plain
    version on the CPU), backward ``wkv6_chunked_bwd``.  r, k and v get
    their gradients in their own dtype; logw, u and the state in float32.
    ``apply(r, k, v, logw, u, state, chunk)``, the tensors contiguous and
    typed as ``wkv6_chunked`` takes them."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, state)
        return wkv6_chunked(r, k, v, logw, u, state, chunk=chunk)

    @staticmethod
    def backward(ctx, do, dhT):
        r, k, v, logw, u, state = ctx.saved_tensors
        do = torch.zeros(r.shape, dtype=torch.float32, device=r.device) if do is None \
            else do.to(torch.float32).contiguous()
        dhT = None if dhT is None else dhT.to(torch.float32).contiguous()
        dr, dk, dv, dlogw, du, dh0 = wkv6_chunked_bwd(r, k, v, logw, u, state, do, dhT)
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlogw, du,
                None if state is None else dh0, None)
