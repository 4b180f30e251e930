"""Mamba's selective scan with a carried state (jamba's SSM layer).

Per (batch, channel d, state n), token by token:
    dA = exp(dt_t A),  dBx = (dt_t x_t) B_t,  h = dA h + dBx,
    y_t = sum_n h[n] C_t[n] + D x_t
the recurrence the reference evaluates as an associative scan in plain jnp
(``repro.models.ssm.mamba_mix``).  With ``h0=None`` the state starts at
zero.

For CUDA tensors this launches the kernel of ``csrc/mamba_scan.cu`` (two
lanes a (batch, channel) with 8 states each in registers, four at a decode
step; y summed in one fixed tree), which reads dt, x, B and C as float32 or
as bfloat16, the LM's activations as they come; for CPU tensors it runs the
plain version in ``ref.py``.

``mamba_scan_bwd`` is its gradient (``csrc/mamba_scan_bwd.cu`` on the card:
a stored state every 8 tokens, each window's states recomputed with the
forward's arithmetic and walked backward with the decays recomputed, so two
blocks of 8 warps fit an SM; tiles staged by ``cp.async`` while the last is
walked; the sums over a block's channels through shared memory, every sum
in a fixed order; ``ref.mamba_scan_bwd_ref`` on the CPU), and ``MambaScan``
the autograd function that pairs the two, through which the LM trains.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, cost
from .ref import mamba_scan_bwd_ref, mamba_scan_ref

MAX_DS = 16                 # states a channel keeps in registers (csrc/mamba_scan.cu)
IN_DTYPES = (torch.float32, torch.bfloat16)


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
               A: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
               chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (B, S, di) and Bm, Cm: (B, S, ds), float32 or bfloat16, one
    dtype; A: (di, ds) and D: (di,) float32; h0: (B, di, ds) float32, or
    None for a zero state.  Returns (y (B, S, di), hT (B, di, ds)), both
    float32.  ``chunk`` is the plain version's checkpoint window (the
    kernel walks every token in one launch).  A fake dt takes the
    shape-only branch (``cost.shape_only``)."""
    if cost.shape_only(dt):
        B, S, di = dt.shape
        ds = Bm.shape[-1]
        cost.record(cost.SCAN, cost.scan_bytes(B, S, di, ds, dt.element_size(), h0 is not None),
                    cost.scan_ops(B, S, di, ds), cost.dtype_name(dt))
        return (dt.new_empty((B, S, di), dtype=torch.float32),
                dt.new_empty((B, di, ds), dtype=torch.float32))
    if dt.device.type == "cpu":
        return mamba_scan_ref(dt, x, Bm, Cm, A, D, h0, chunk=chunk)
    name = "mamba_scan"
    B, S, di, ds = _check(name, dt, x, Bm, Cm, A, D, {} if h0 is None else {"h0": h0})
    y = torch.empty((B, S, di), device=dt.device, dtype=torch.float32)
    hT = torch.empty((B, di, ds), device=dt.device, dtype=torch.float32)
    with torch.cuda.device(dt.device):
        rc = _build.library("mamba_scan").mamba_scan_launch(
            dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
            D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
            B, S, di, ds, int(dt.dtype == torch.bfloat16), _build.stream_of(dt))
    _build.check_launch(rc, name)
    mamba_scan.launches += 1
    return y, hT


mamba_scan.launches = 0


def _check(name: str, dt, x, Bm, Cm, A, D, state: dict, **more) -> tuple:
    """Device, contiguity, dtypes and shapes of the scan's arguments:
    ``state`` holds the (B, di, ds) float32 states that are given, ``more``
    the (B, S, di) float32 gradients.  Returns (B, S, di, ds)."""
    _build.require_cuda(name, dt, dt=dt, x=x, Bm=Bm, Cm=Cm, A=A, D=D, **state, **more)
    _build.require_dtype(name, "dt", dt, *IN_DTYPES)
    for arg, t in dict(x=x, Bm=Bm, Cm=Cm).items():
        if t.dtype != dt.dtype:
            raise TypeError(f"{name}: dt, x, Bm and Cm must share one dtype, got dt "
                            f"{dt.dtype} and {arg} {t.dtype}")
    for arg, t in dict(A=A, D=D, **state, **more).items():
        _build.require_dtype(name, arg, t, torch.float32)
    B, S, di = dt.shape
    ds = Bm.shape[-1]
    if (x.shape != dt.shape or Bm.shape != (B, S, ds) or Cm.shape != Bm.shape
            or A.shape != (di, ds) or D.shape != (di,)
            or any(t.shape != (B, di, ds) for t in state.values())
            or any(t.shape != dt.shape for t in more.values())):
        shapes = {a: tuple(t.shape) for a, t in dict(dt=dt, x=x, Bm=Bm, Cm=Cm, A=A, D=D,
                                                     **state, **more).items()}
        raise ValueError(f"{name}: shapes {shapes}")
    if not 1 <= ds <= MAX_DS or B > 65535:
        raise ValueError(f"{name}: {ds} states (1 to {MAX_DS}) at batch {B} (at most 65535)")
    return B, S, di, ds


def mamba_scan_bwd(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   A: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor],
                   dy: Optional[torch.Tensor], dhT: Optional[torch.Tensor] = None, *,
                   chunk: int = 128) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``mamba_scan``'s recurrence: its arguments as they
    went in (h0 None for a zero state), ``dy`` (B, S, di) float32 the
    gradient of y and ``dhT`` (B, di, ds) float32 that of the final state
    (either None: zero).  Returns (ddt, dx, dB, dC, dA, dD, dh0), all
    float32.  ``chunk`` is the plain version's window (the kernel stores a
    state every 8 tokens).  A fake dt takes the shape-only branch
    (``cost.shape_only``)."""
    if cost.shape_only(dt):
        B, S, di = dt.shape
        ds = Bm.shape[-1]
        cost.record(cost.SCAN_BWD, *cost.scan_bwd_work(
            B, S, di, ds, dt.element_size(), h0 is not None, dy is not None, dhT is not None),
            cost.dtype_name(dt))
        f32 = lambda *s: dt.new_empty(s, dtype=torch.float32)
        return (f32(B, S, di), f32(B, S, di), f32(B, S, ds), f32(B, S, ds), f32(di, ds),
                f32(di), f32(B, di, ds))
    if dt.device.type == "cpu":
        return mamba_scan_bwd_ref(dt, x, Bm, Cm, A, D, h0, dy, dhT, chunk=chunk)
    name = "mamba_scan_bwd"
    state = {a: t for a, t in dict(h0=h0, dhT=dhT).items() if t is not None}
    B, S, di, ds = _check(name, dt, x, Bm, Cm, A, D, state,
                          **({} if dy is None else {"dy": dy}))
    f32 = dict(device=dt.device, dtype=torch.float32)
    ddt, dx = torch.empty((B, S, di), **f32), torch.empty((B, S, di), **f32)
    dB, dC = torch.empty((B, S, ds), **f32), torch.empty((B, S, ds), **f32)
    dA, dD, dh0 = torch.empty((di, ds), **f32), torch.empty((di,), **f32), \
        torch.empty((B, di, ds), **f32)
    lib = _build.library("mamba_scan_bwd")
    scratch = torch.empty((max(1, mamba_scan_bwd_scratch_bytes(B, S, di) // 4),), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dt.device):
        rc = lib.mamba_scan_bwd_launch(
            dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
            D.data_ptr(), ptr(h0), ptr(dy), ptr(dhT), ddt.data_ptr(), dx.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), dh0.data_ptr(),
            scratch.data_ptr(), B, S, di, ds, int(dt.dtype == torch.bfloat16),
            _build.stream_of(dt))
    _build.check_launch(rc, name)
    mamba_scan_bwd.launches += 1
    return ddt, dx, dB, dC, dA, dD, dh0


mamba_scan_bwd.launches = 0


def mamba_scan_bwd_scratch_bytes(B: int, S: int, di: int) -> int:
    """Bytes of the scratch the gradient's kernel takes at (B, S, di), as
    its C entry counts them (``cost.scan_bwd_scratch`` predicts them)."""
    floats = ctypes.c_longlong()
    _build.check_launch(_build.library("mamba_scan_bwd").mamba_scan_bwd_scratch(
        B, S, di, ctypes.byref(floats)), "mamba_scan_bwd_scratch")
    return 4 * floats.value


def mamba_scan_bwd_occupancy(bf16: bool, vec: bool = True) -> dict:
    """The gradient's main kernel on the current card, its bf16 or float32
    and vector or scalar instance: blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), shared bytes and
    threads a block."""
    out = (ctypes.c_int * 3)()
    _build.check_launch(_build.library("mamba_scan_bwd").mamba_scan_bwd_occupancy(
        int(bf16), int(vec), out), "mamba_scan_bwd_occupancy")
    return dict(blocks_per_sm=out[0], shared_bytes=out[1], threads=out[2])


class MambaScan(torch.autograd.Function):
    """``mamba_scan`` with its gradient: forward one launch of the scan
    kernel, backward one launch of ``mamba_scan_bwd`` (their plain versions
    on the CPU).  dt, x, Bm and Cm get their gradients in their own dtype;
    A, D and the state in float32.  ``apply(dt, x, Bm, Cm, A, D, h0,
    chunk)``, the tensors contiguous and typed as ``mamba_scan`` takes
    them."""

    @staticmethod
    def forward(ctx, dt, x, Bm, Cm, A, D, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(dt, x, Bm, Cm, A, D, h0)
        return mamba_scan(dt, x, Bm, Cm, A, D, h0, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dhT):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:7]
        if (dy is None and dhT is None) or not any(need):
            return (None,) * 8
        f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
        grads = mamba_scan_bwd(*saved, f32(dy), f32(dhT), chunk=ctx.chunk)
        return tuple(None if not n else gr if t.dtype == torch.float32 else gr.to(t.dtype)
                     for gr, t, n in zip(grads, saved, need)) + (None,)
