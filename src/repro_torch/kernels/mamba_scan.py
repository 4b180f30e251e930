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
plain version in ``ref.py``.  ``MambaScan`` is the autograd function the LM
calls: on the CPU its backward differentiates the plain version; on the
card the scan has no backward kernel yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, cost
from .ref import mamba_scan_ref

MAX_DS = 16                 # states a channel keeps in registers (csrc/mamba_scan.cu)
IN_DTYPES = (torch.float32, torch.bfloat16)
GRAD_ITEM = "ROADMAP.md item 7.13"


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
    state = {} if h0 is None else {"h0": h0}
    _build.require_cuda(name, dt, dt=dt, x=x, Bm=Bm, Cm=Cm, A=A, D=D, **state)
    _build.require_dtype(name, "dt", dt, *IN_DTYPES)
    for arg, t in dict(x=x, Bm=Bm, Cm=Cm).items():
        if t.dtype != dt.dtype:
            raise TypeError(f"{name}: dt, x, Bm and Cm must share one dtype, got dt "
                            f"{dt.dtype} and {arg} {t.dtype}")
    for arg, t in dict(A=A, D=D, **state).items():
        _build.require_dtype(name, arg, t, torch.float32)
    B, S, di = dt.shape
    ds = Bm.shape[-1]
    if (x.shape != dt.shape or Bm.shape != (B, S, ds) or Cm.shape != Bm.shape
            or A.shape != (di, ds) or D.shape != (di,)
            or any(t.shape != (B, di, ds) for t in state.values())):
        shapes = {a: tuple(t.shape) for a, t in dict(dt=dt, x=x, Bm=Bm, Cm=Cm, A=A, D=D,
                                                     **state).items()}
        raise ValueError(f"{name}: shapes {shapes}")
    if not 1 <= ds <= MAX_DS or B > 65535:
        raise ValueError(f"{name}: {ds} states (1 to {MAX_DS}) at batch {B} (at most 65535)")
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


class MambaScan(torch.autograd.Function):
    """``mamba_scan`` as autograd sees it: forward one launch of the kernel
    (its plain version on the CPU).  Backward, on the CPU, differentiates
    the plain version, recomputed from the saved inputs one checkpointed
    window at a time; on the card it raises, since the scan's gradient has
    no kernel yet (``GRAD_ITEM``).  ``apply(dt, x, Bm, Cm, A, D, h0,
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
        if cost.shape_only(saved[0]):
            return MambaScan._shape_only_backward(ctx, saved)
        if saved[0].device.type != "cpu":
            raise NotImplementedError(
                f"mamba_scan: the selective scan has no backward kernel on the card yet "
                f"({GRAD_ITEM}); Mamba layers train on the CPU")
        need = ctx.needs_input_grad[:7]
        grads = [None] * 8
        outs = [(o, g) for o, g in ((0, dy), (1, dhT)) if g is not None]
        if not outs or not any(need):
            return tuple(grads)
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(saved, need)]
            y, hT = mamba_scan_ref(*ins, chunk=ctx.chunk)
            wrt = [t for t, n in zip(ins, need) if n]
            got = torch.autograd.grad([(y, hT)[o] for o, _ in outs], wrt,
                                      [g.to(torch.float32) for _, g in outs],
                                      allow_unused=True)
        it = iter(got)
        for i, n in enumerate(need):
            if n:
                grads[i] = next(it)
        return tuple(grads)

    @staticmethod
    def _shape_only_backward(ctx, saved):
        """The gradient's shape-only branch: empty gradients of the inputs'
        shapes and dtypes, and the work a backward kernel would do
        (``cost.scan_bwd_work``, an estimate) recorded as ``mamba_scan_bwd``,
        a kernel the card does not have yet (``GRAD_ITEM``)."""
        dt, x, Bm, Cm, A, D, h0 = saved
        B, S, di = dt.shape
        cost.record(cost.SCAN_BWD, *cost.scan_bwd_work(B, S, di, Bm.shape[-1],
                                                       dt.element_size(), h0 is not None))
        return tuple(None if t is None or not n else torch.empty_like(t)
                     for t, n in zip(saved, ctx.needs_input_grad[:7])) + (None,)
