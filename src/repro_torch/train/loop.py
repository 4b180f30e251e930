"""Train step builder and fault-tolerant loop (counterpart of
``repro.train.loop``).

make_train_step(cfg, opt_cfg, train_cfg) -> step(state, batch) with:
 * microbatch gradient accumulation, a Python loop over microbatches that
   sums the gradients in ``accum_dtype`` (the reference's lax.scan), so
   activation memory is one microbatch;
 * per-group activation checkpointing (``lm.forward(remat=True)``);
 * optional int8 gradient compression with error feedback, applied to the
   accumulated gradient before the optimizer, the residual carried to the
   next step;
 * AdamW with float32 / bfloat16 / int8 moments and float32 masters
   (``optimizer.py``), updating the state in place.

The loop adds checkpoint-every-N with async writes, restart from the latest
complete checkpoint, a checkpoint on SIGTERM, and a straggler watchdog that
flags steps slower than ``straggler_factor`` x the running median.

On a mesh (``init_state(mesh=)``, with the mesh installed by
``models.common.set_mesh``), the parameters, the optimizer state and the
error-feedback residuals are laid out by the training specs
(``state_specs``): each rank holds its blocks.  Each data rank takes its
rows of every microbatch (``SyntheticData.host_batch``); a layer gathers a
weight whole while it computes, and the gather's backward sums the gradient
over the batch axes that split the weight (``core.layers.Sharded``); the
loop sums the rest of it over the batch axes (``_sum_over_batch``) before
the optimizer, so every rank steps on the whole batch's gradient.  A mesh that
splits no rows ((1, 1), (1, M)) computes one device's loss and gradients
bit for bit.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..core.layers import Sharded, local_of
from ..models import lm
from ..models.common import (all_reduce_batch, batch_axes, batch_rank, batch_size, get_mesh,
                             split_rows)
from ..models.config import ModelConfig
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    accum_dtype: str = "float32"      # bfloat16 halves the accumulation buffers
    compress_grads: bool = False      # int8 + error feedback
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 2.0


# ---------------------------------------------------------------------------
# Gradient compression (int8, error feedback)
# ---------------------------------------------------------------------------
def _compress_ef(g: torch.Tensor, residual: torch.Tensor, like=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``like``: the ``Sharded`` parameter ``g`` is this rank's block of;
    the scale is then the largest magnitude over the whole leaf."""
    g = g.to(torch.float32) + residual
    amax = g.abs().max()
    if isinstance(like, Sharded):
        import torch.distributed as dist
        for a in like.split_axes():
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=like.mesh.get_group(a))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127)
    deq = q * scale                    # the int8 payload, dequantized
    return deq, g - deq


def compress_grads_ef(grads: Any, residuals: Any) -> Tuple[Any, Any]:
    """(dequantized int8 gradients, new residuals), two trees shaped as
    ``grads``; residuals laid out on a mesh stay laid out alike."""
    res = leaves(residuals)
    pairs = [_compress_ef(g, local_of(r), r) for g, r in zip(leaves(grads), res)]
    return (unflatten(grads, [p[0] for p in pairs]),
            unflatten(residuals, [r.like(p[1]) if isinstance(r, Sharded) else p[1]
                                  for r, p in zip(res, pairs)]))


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def init_state(generator: torch.Generator, cfg: ModelConfig, opt_cfg: AdamWConfig,
               train_cfg: TrainConfig = TrainConfig(), device="cuda",
               mesh=None) -> Dict[str, Any]:
    """Parameters drawn from ``generator`` (``lm.init_params``) on
    ``device``, the optimizer state, step 0.  With ``mesh``, the parameters
    laid out by the training specs (``lm.shard_params(serving=False)``),
    and the moments, masters and residuals as their parameters."""
    params = lm.init_params(generator, cfg, device)
    if mesh is not None:
        params = lm.shard_params(params, cfg, mesh, serving=False)
    state = {"params": params, "opt": adamw_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if train_cfg.compress_grads:
        def zeros(p):
            z = torch.zeros(local_of(p).shape, dtype=torch.float32, device=p.device)
            return p.like(z) if isinstance(p, Sharded) else z
        state["ef_residual"] = tree_map(zeros, params)
    return state


def state_specs(cfg: ModelConfig, state: Dict[str, Any]) -> Dict[str, Any]:
    """The spec tree of a training state, for ``CheckpointManager.restore(
    shardings=)``: the parameters' training specs, the same for their
    masters, moments and residuals; an int8 moment's (codes, scales) pair
    as a list of two specs, the scales whole along the last dim; the steps
    ``()``.  A spec is a tuple, so a list holds a pair."""
    pspecs = lm.param_specs(cfg, state["params"], serving=False)

    def moment(enc, spec):
        return [spec, spec[:-1] + (None,)] if isinstance(enc, tuple) else spec

    def mirror(tree):
        flat = leaves(pspecs, tuples=False)
        return unflatten(state["params"], [moment(e, s) for e, s in
                                           zip(leaves(tree, tuples=False), flat)])
    out = {"params": pspecs,
           "opt": {k: (() if k == "step" else mirror(v)) for k, v in state["opt"].items()},
           "step": ()}
    if "ef_residual" in state:
        out["ef_residual"] = pspecs
    return out


def _value_and_grad(params: Any, batch: Dict[str, torch.Tensor], cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    ps = [local_of(p) for p in leaves(params)]
    for p in ps:
        p.requires_grad_(True)
    loss = lm.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(ps, grads)]


def _sum_over_batch(params: Any, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient summed over the batch axes its parameter is not split
    over (those it is split over the gather's backward summed already):
    a replicated leaf's over all of them.  One ``all_reduce`` per axis for
    the leaves of one set of axes and one dtype."""
    axes = batch_axes()
    if not axes:
        return grads
    buckets: Dict[tuple, List[int]] = {}
    for i, p in enumerate(leaves(params)):
        split = p.split_axes() if isinstance(p, Sharded) else ()
        todo = tuple(a for a in axes if a not in split)
        if todo:
            buckets.setdefault((todo, grads[i].dtype), []).append(i)
    grads = list(grads)
    for (todo, _), idx in buckets.items():
        flat = all_reduce_batch(torch.cat([grads[i].reshape(-1) for i in idx]), axes=todo)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view_as(grads[i])
    return grads


def loss_and_grads(params: Any, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   train_cfg: TrainConfig = TrainConfig()) -> Tuple[torch.Tensor, Any]:
    """jax.value_and_grad(lm.loss_fn), over ``train_cfg.grad_accum``
    microbatches (the batch's rows cut in order) whose gradients add in
    ``accum_dtype`` and are divided by their count; the loss is their mean.
    Returns (loss, gradient tree shaped as ``params``).

    With a mesh installed, ``batch`` is this rank's rows (``data.host_rows``),
    the parameters may be laid out (``Sharded``) and the gradients are this
    rank's blocks of the whole batch's; the loss is the whole batch's."""
    accum = train_cfg.grad_accum
    with split_rows():
        if accum == 1:
            loss, grads = _value_and_grad(params, batch, cfg)
        else:
            adt = getattr(torch, train_cfg.accum_dtype)
            grads = [torch.zeros(local_of(p).shape, dtype=adt, device=p.device)
                     for p in leaves(params)]
            losses = []
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                mb_loss, g = _value_and_grad(params, mb, cfg)
                grads = [a + b.to(adt) for a, b in zip(grads, g)]
                losses.append(mb_loss)
            loss, grads = torch.stack(losses).mean(), [g / accum for g in grads]
        return all_reduce_batch(loss), unflatten(params, _sum_over_batch(params, grads))


def apply_grads(state: Dict[str, Any], grads: Any, opt_cfg: AdamWConfig,
                train_cfg: TrainConfig = TrainConfig()) -> Tuple[Dict[str, Any], Dict]:
    """Gradient compression (if on) and the AdamW step, in place on
    ``state``; returns (state, metrics: grad_norm, lr)."""
    if train_cfg.compress_grads:
        grads, state["ef_residual"] = compress_grads_ef(grads, state["ef_residual"])
    _, _, metrics = adamw_update(state["params"], grads, state["opt"], opt_cfg)
    state["step"] += 1
    return state, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    train_cfg: TrainConfig = TrainConfig()) -> Callable:
    """step(state, batch) -> (state, metrics: loss, grad_norm, lr), the
    state updated in place; the batch's tensors are moved to the
    parameters' device."""
    def step_fn(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        device = state["step"].device
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        loss, grads = loss_and_grads(state["params"], batch, cfg, train_cfg)
        state, metrics = apply_grads(state, grads, opt_cfg, train_cfg)
        metrics["loss"] = loss
        return state, metrics

    return step_fn


# ---------------------------------------------------------------------------
# Fault-tolerant loop
# ---------------------------------------------------------------------------
def train_loop(state, step_fn, data, n_steps: int, ckpt=None,
               train_cfg: TrainConfig = TrainConfig(), log=print
               ) -> Tuple[Any, Dict[str, list]]:
    """Steps from ``state["step"]`` to ``n_steps``, batch ``data.batch(step)``
    at each (on a mesh, this rank's rows of it); checkpoints every
    ``checkpoint_every`` steps and on SIGTERM (then stops).  On a mesh the
    ranks agree on SIGTERM after every step (one rank's signal stops them
    all at the same step, so none enters a collective alone), and a
    checkpoint is a collective.  Returns (state, history: loss, step_time,
    stragglers)."""
    import torch.distributed as dist
    preempted = {"flag": False}

    def _sigterm(_sig, _frm):
        preempted["flag"] = True
    old = signal.signal(signal.SIGTERM, _sigterm)

    start = int(state["step"])
    history: Dict[str, list] = {"loss": [], "step_time": [], "stragglers": []}
    times: list = []
    n_rows, row_rank = batch_size(), batch_rank()
    agree = get_mesh() is not None and dist.get_world_size() > 1
    try:
        for step in range(start, n_steps):
            t0 = time.perf_counter()
            batch = (data.host_batch(step, row_rank, n_rows, train_cfg.grad_accum)
                     if n_rows > 1 else data.batch(step))
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])          # waits for the step
            dt = time.perf_counter() - t0
            times.append(dt)
            med = sorted(times)[len(times) // 2]
            if len(times) > 5 and dt > train_cfg.straggler_factor * med:
                history["stragglers"].append(step)
                log(f"[straggler] step {step}: {dt:.3f}s vs median {med:.3f}s")
            history["loss"].append(loss)
            history["step_time"].append(dt)
            if step % train_cfg.log_every == 0:
                log(f"step {step}: loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            if ckpt is not None and (step + 1) % train_cfg.checkpoint_every == 0:
                ckpt.save(step + 1, state)
            if agree:
                flag = torch.tensor(float(preempted["flag"]), device=state["step"].device)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                preempted["flag"] = bool(flag)
            if preempted["flag"]:
                log(f"[preempt] SIGTERM at step {step}; checkpointing and exiting")
                if ckpt is not None:
                    ckpt.save(step + 1, state, blocking=True)
                break
    finally:
        signal.signal(signal.SIGTERM, old)
        if ckpt is not None:
            ckpt.wait()
    return state, history
