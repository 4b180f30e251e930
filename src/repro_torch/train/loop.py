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
flags steps slower than ``straggler_factor`` x the running median.  The port
runs on one device: there is no mesh.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..models import lm
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
def _compress_ef(g: torch.Tensor, residual: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    g = g.to(torch.float32) + residual
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127)
    deq = q * scale                    # the int8 payload, dequantized
    return deq, g - deq


def compress_grads_ef(grads: Any, residuals: Any) -> Tuple[Any, Any]:
    """(dequantized int8 gradients, new residuals), two trees shaped as
    ``grads``."""
    pairs = [_compress_ef(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    return (unflatten(grads, [p[0] for p in pairs]),
            unflatten(grads, [p[1] for p in pairs]))


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def init_state(generator: torch.Generator, cfg: ModelConfig, opt_cfg: AdamWConfig,
               train_cfg: TrainConfig = TrainConfig(), device="cuda") -> Dict[str, Any]:
    """Parameters drawn from ``generator`` (``lm.init_params``) on
    ``device``, the optimizer state, step 0."""
    params = lm.init_params(generator, cfg, device)
    state = {"params": params, "opt": adamw_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if train_cfg.compress_grads:
        state["ef_residual"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return state


def _value_and_grad(params: Any, batch: Dict[str, torch.Tensor], cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss = lm.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(ps, grads)]


def loss_and_grads(params: Any, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   train_cfg: TrainConfig = TrainConfig()) -> Tuple[torch.Tensor, Any]:
    """jax.value_and_grad(lm.loss_fn), over ``train_cfg.grad_accum``
    microbatches (the batch's rows cut in order) whose gradients add in
    ``accum_dtype`` and are divided by their count; the loss is their mean.
    Returns (loss, gradient tree shaped as ``params``)."""
    accum = train_cfg.grad_accum
    if accum == 1:
        loss, grads = _value_and_grad(params, batch, cfg)
        return loss, unflatten(params, grads)
    adt = getattr(torch, train_cfg.accum_dtype)
    g_sum = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in leaves(params)]
    losses = []
    for i in range(accum):
        mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
              for k, v in batch.items()}
        loss, g = _value_and_grad(params, mb, cfg)
        g_sum = [a + b.to(adt) for a, b in zip(g_sum, g)]
        losses.append(loss)
    return torch.stack(losses).mean(), unflatten(params, [g / accum for g in g_sum])


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
    at each; checkpoints every ``checkpoint_every`` steps and on SIGTERM
    (then stops).  Returns (state, history: loss, step_time, stragglers)."""
    preempted = {"flag": False}

    def _sigterm(_sig, _frm):
        preempted["flag"] = True
    old = signal.signal(signal.SIGTERM, _sigterm)

    start = int(state["step"])
    history: Dict[str, list] = {"loss": [], "step_time": [], "stragglers": []}
    times: list = []
    try:
        for step in range(start, n_steps):
            t0 = time.perf_counter()
            batch = data.batch(step)
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
