"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``).

Two paths, chosen by ``moe_ffn`` as the reference chooses:

1. ``moe_dispatch`` (a mesh installed, prefill or training): each data
   rank routes its rows of the batch, packs them into per-destination
   capacity buffers (``_local_pack``: rank within the expert by a cumsum,
   no sort), swaps them with ``all_to_all_single`` over the data ranks,
   runs its expert slot on what it received (its ``d_ff / model``
   columns; the ff-partial outputs summed over 'model' by
   ``all_reduce``), swaps them back and combines in float32
   (``_local_unpack``).  Serving, every rank holds the whole batch: it
   takes its rows, and the rows are gathered over 'data' at the end (by
   a plain ``all_gather``: this form refuses autograd).  Training
   (``common.split_rows``), a rank holds only its rows, and takes and
   returns them.  Capacity C = ceil(T_local * top_k *
   capacity_factor / n_dest); overflow is dropped (GShard).  The
   gradient: each ``all_to_all`` transposes to the same ``all_to_all``
   back, the 'model' sum to the identity (and the slot's input gathers
   its gradient over 'model'), and a slot's weight gradient lands on the
   whole (E, d, ff) leaf, its replicas summed over the data ranks (the
   reference's ``jnp.repeat`` transpose): by the gather's
   ``reduce_scatter`` for a laid-out leaf, by the train loop's sum over
   the batch axes for a replicated one, as for the router.
2. ``moe_dense`` (no mesh, decode, small batches): every expert on every
   token, then the masked combine.

The experts are plain dense ``(E, d, ff)`` / ``(E, ff, d)`` tensors, never
epitomized (the reference's ``pim.workloads.lm_layers`` lists no expert
site), so their products are ``torch.einsum``s, as the reference's are
``jnp.einsum``s outside any Pallas kernel.  The math is per token: a row's
output depends on its own activation alone.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.layers import axis_sizes, local_of, unshard
from .common import BATCH_AXES, TENSOR_AXIS, act_fn, batch_size, get_mesh, rows_split
from .config import ModelConfig


def init_moe(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's layout: a float32 ``router`` (d, E); ``w_gate`` and
    ``w_up`` (E, d, ff) and ``w_down`` (E, ff, d) in ``cfg.pdtype``.  Drawn
    on the generator's device expert by expert, each cast to pdtype as it
    is drawn: a float32 copy of a whole expert tensor is 1.68 GB at
    phi3.5-moe's width."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator, device=generator.device) * scale

    def experts(M, N):
        w = torch.empty((E, M, N), dtype=cfg.pdtype, device=device)
        for e in range(E):
            w[e] = randn(M, N, scale=1.0 / math.sqrt(M))
        return w

    router = randn(d, E, scale=1.0 / math.sqrt(d)).to(device=device, dtype=torch.float32)
    return {"router": router, "w_gate": experts(d, ff), "w_up": experts(d, ff),
            "w_down": experts(ff, d)}


def moe_param_specs(cfg: ModelConfig) -> dict:
    """E replicated; d_model FSDP-sharded over data; d_ff TP over model."""
    return {"router": (None, None), "w_gate": (None, "data", TENSOR_AXIS),
            "w_up": (None, "data", TENSOR_AXIS), "w_down": (None, TENSOR_AXIS, "data")}


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """top-k routing.  x2d: (T, d) -> (weights (T, k) float32, experts (T, k))."""
    logits = x2d.to(torch.float32) @ router
    weights, experts = torch.topk(logits, cfg.top_k, dim=-1)
    return torch.softmax(weights, dim=-1), experts


def moe_dense(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every expert on every token, then the masked combine: x (B, S, d) ->
    (B, S, d) in x's dtype.  The (T, E) combine matrix holds each token's k
    routing weights at its k distinct experts (a scatter, deterministic);
    the expert products run in x's dtype and their weighted sum over E in
    float32.  The reference's three einsums, with the experts on the
    leading (batch) axis: each is one batched matmul over E that reads the
    (E, d, ff) weights where they lie.  (``torch.einsum("td,edf->tef")``
    would make E an output axis of one (T, d) x (d, E ff) product and copy
    both input weights into that layout on every call.)"""
    B, S, d = x.shape
    act = act_fn(cfg.act)
    params = {k: unshard(v) for k, v in params.items()}
    x2 = x.reshape(-1, d)
    weights, experts = _route(x2, params["router"], cfg)               # (T, k)
    comb = torch.zeros((x2.shape[0], cfg.n_experts), dtype=torch.float32,
                       device=x.device).scatter(1, experts, weights)
    xe = x2.expand(cfg.n_experts, *x2.shape)                           # (E, T, d)
    g = torch.bmm(xe, params["w_gate"].to(x.dtype))
    u = torch.bmm(xe, params["w_up"].to(x.dtype))
    h = act(g) * u                                                     # (E, T, ff)
    del g, u
    o = torch.bmm(h, params["w_down"].to(x.dtype))                     # (E, T, d)
    del h
    y = torch.einsum("etd,te->td", o.to(torch.float32), comb)
    return y.reshape(B, S, d).to(x.dtype)


# ---------------------------------------------------------------------------
# Dispatch: all_to_all over the data ranks
# ---------------------------------------------------------------------------
def _local_pack(x2: torch.Tensor, weights: torch.Tensor, experts: torch.Tensor,
                n_dest: int, cap: int, repl: int, n_experts: int):
    """Pack local tokens into (n_dest, cap, d) send buffers.

    Destination of expert e, replica r: ``e * repl + r``; a token's rank
    in its expert's queue (its order among the (token, slot) pairs routed
    there) spreads it round-robin over the replicas (``rank % repl``) and
    gives its slot (``rank // repl``); a slot past ``cap`` is dropped.
    Returns (buf, (flat_t, flat_w, dest, slot, ok))."""
    T, d = x2.shape
    k = experts.shape[1]
    dev = x2.device
    flat_e = experts.reshape(-1)                                  # (T k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = weights.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_e, n_experts)      # (T k, E)
    rank = (onehot.cumsum(0) - 1)[torch.arange(T * k, device=dev), flat_e]
    dest = flat_e * repl + rank % repl
    slot = rank // repl
    ok = slot < cap
    slot = torch.where(ok, slot, torch.zeros_like(slot))
    buf = torch.zeros((n_dest, cap, d), dtype=x2.dtype, device=dev)
    src = torch.where(ok[:, None], x2[flat_t], torch.zeros((), dtype=x2.dtype, device=dev))
    buf.index_put_((dest, slot), src, accumulate=True)
    return buf, (flat_t, flat_w, dest, slot, ok)


def _local_unpack(recv_y: torch.Tensor, info, T: int, d: int) -> torch.Tensor:
    """The (T, d) float32 combine of the returned rows: each (token, slot)
    pair's row, zero where it was dropped, times its routing weight, the k
    of a token summed in slot order."""
    flat_t, flat_w, dest, slot, ok = info
    y_tok = recv_y[dest, slot].to(torch.float32)                  # (T k, d)
    y_tok = torch.where(ok[:, None], y_tok, torch.zeros((), device=y_tok.device))
    y_tok = y_tok * flat_w[:, None]
    # flat_t is each token's k pairs in a row: the sum over them is the
    # reference's scatter-add onto token rows, in a fixed order
    return y_tok.reshape(T, -1, d).sum(1)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks over a group; its transpose is
    the same exchange, so the backward swaps the gradients back."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist
        ctx.group = group
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllToAll.apply(g, ctx.group), None


class _SumOverModel(torch.autograd.Function):
    """The 'model' ranks' partial outputs summed (``all_reduce``).  Every
    rank of the group goes on with the same sum, so the gradient of each
    partial is the sum's own: the backward is the identity."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _FromModel(torch.autograd.Function):
    """The input of a 'model'-split product: the identity forward; the
    backward sums the ranks' gradients, each rank's columns having
    contributed their part of it (``all_reduce``)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def moe_dispatch(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Expert parallelism over the data ranks (see the module docstring):
    x (B, S, d) -> (B, S, d) in x's dtype; serving, x is the whole batch on
    every rank and so is the result; training (``common.split_rows``),
    both are this rank's rows."""
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("moe_dispatch needs a mesh (models.common.set_mesh)")
    names = mesh.mesh_dim_names
    dp_axes = tuple(a for a in BATCH_AXES if a in names)
    if len(dp_axes) != 1:
        raise ValueError(f"moe_dispatch runs over one batch axis, the mesh has {dp_axes}")
    dp_group, dp_rank = mesh.get_group(dp_axes[0]), mesh.get_local_rank(dp_axes[0])
    n_dest = batch_size(mesh)
    tp = axis_sizes(mesh).get(TENSOR_AXIS, 1)
    tp_rank = mesh.get_local_rank(TENSOR_AXIS) if tp > 1 else 0
    E = cfg.n_experts
    repl = max(1, n_dest // E)            # replicas per expert
    if E * repl != n_dest:
        raise ValueError(f"experts {E} not mappable onto {n_dest} data shards")
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} does not split over {tp} model ranks")
    act = act_fn(cfg.act)
    whole = not rows_split()
    if whole and torch.is_grad_enabled() and (
            x.requires_grad or any(local_of(p).requires_grad for p in params.values())):
        # the whole batch comes back through a plain all_gather, which
        # autograd cannot see: train inside common.split_rows
        raise NotImplementedError("moe_dispatch has a gradient only with the rows "
                                  "split (models.common.split_rows)")
    B, S, d = x.shape
    Bl = B // n_dest if whole else B
    T_local = Bl * S
    cap = max(1, math.ceil(T_local * cfg.top_k * cfg.capacity_factor / n_dest))

    x2 = (x[dp_rank * Bl:(dp_rank + 1) * Bl] if whole else x).reshape(-1, d)
    weights, experts = _route(x2, unshard(params["router"]), cfg)
    buf, info = _local_pack(x2, weights, experts, n_dest, cap, repl, E)
    recv = _AllToAll.apply(buf, dp_group)
    # this rank's expert slot (slot s holds expert s // repl) and its ff columns
    e, f = dp_rank // repl, cfg.d_ff // tp
    cols = slice(tp_rank * f, (tp_rank + 1) * f)
    tok = recv.reshape(-1, d)                                     # (n_dest cap, d)
    if tp > 1:
        tok = _FromModel.apply(tok, mesh.get_group(TENSOR_AXIS))
    w_gate, w_up, w_down = (unshard(params[k]) for k in ("w_gate", "w_up", "w_down"))
    g = tok @ w_gate[e][:, cols].to(x.dtype)
    u = tok @ w_up[e][:, cols].to(x.dtype)
    y = (act(g) * u) @ w_down[e][cols].to(x.dtype)                # partial over ff
    if tp > 1:
        y = _SumOverModel.apply(y, mesh.get_group(TENSOR_AXIS))
    back = _AllToAll.apply(y, dp_group)
    out = _local_unpack(back.reshape(n_dest, cap, d), info, T_local, d)
    out = out.reshape(Bl, S, d).to(x.dtype)
    if not whole:
        return out
    import torch.distributed as dist
    parts = [torch.empty_like(out) for _ in range(n_dest)]
    dist.all_gather(parts, out, group=dp_group)
    return torch.cat(parts, 0)


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
            force_dense: bool = False) -> torch.Tensor:
    """Entry point: the reference's choice of path.  Dispatch needs a
    mesh, the batch divisible over the data ranks, an integer replica count
    and (unless ``cfg.moe_decode_dispatch``) at least one local token per
    expert; otherwise (no mesh, decode, tiny batches) the dense path.  The
    choice is made on the whole batch, as the reference sees it: training
    (``common.split_rows``), x is this rank's rows of a batch n_dp times
    as long."""
    mesh = get_mesh()
    if mesh is None or force_dense:
        return moe_dense(params, x, cfg)
    n_dp = batch_size(mesh)
    B, S, _ = x.shape
    if rows_split():
        B *= n_dp
    if B % n_dp != 0 or n_dp % cfg.n_experts != 0:
        return moe_dense(params, x, cfg)
    if (B // n_dp) * S < cfg.n_experts and not cfg.moe_decode_dispatch:
        return moe_dense(params, x, cfg)
    return moe_dispatch(params, x, cfg)
