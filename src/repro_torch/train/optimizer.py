"""AdamW on tensors (counterpart of ``repro.train.optimizer``):

 * float32 master weights when params are in a lower precision;
 * float32, bfloat16 or int8 block-quantized first and second moments (the
   int8 ones in blocks of 256 along the last dim, the second moment in the
   sqrt domain);
 * global-norm gradient clipping, decoupled weight decay (none on vectors),
   linear warmup then cosine decay.

The arithmetic is the reference's, op for op, in float32.  Weight decay
skips vectors by their rank as the reference stacks them: it stacks the
LM's groups over a leading axis, where the port keeps a list of per-group
dicts, so a leaf under a list counts one axis more (a group's norm weights
are decayed, the final norm is not, as in the reference).  A step updates
the parameters, the moments and the masters in place under ``no_grad``
(the reference returns new trees): at rwkv6-7b's 2.3e9 parameters a second
copy of the state would not fit beside the first.  The optimizer state is
``{"step": int32 0-d tensor, "m": tree, "v": tree[, "master": tree]}``, each
tree shaped as the parameters, an int8 moment's leaf a (codes, scales)
pair.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .tree import leaves, tree_map

_BLOCK = 256   # quantization block for int8 moments


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moments_dtype: str = "float32"       # float32 | bfloat16 | int8
    master_dtype: str = "float32"        # master copy when params are low-p


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32 on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


# -- int8 block quantization of moments (shape-preserving, blocks along the
# last dim) ------------------------------------------------------------------
def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.ndim == 0:
        x = x[None]
    last = x.shape[-1]
    nb = -(-last // _BLOCK)
    xp = F.pad(x, (0, nb * _BLOCK - last))
    blocks = xp.reshape(*x.shape[:-1], nb, _BLOCK)
    scale = blocks.abs().amax(-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    q = q.reshape(xp.shape)[..., :last].to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    last = q.shape[-1]
    nb = scale.shape[-1]
    qp = F.pad(q, (0, nb * _BLOCK - last))
    blocks = qp.reshape(*q.shape[:-1], nb, _BLOCK).to(torch.float32)
    x = (blocks * scale[..., None]).reshape(qp.shape)[..., :last]
    return x.reshape(shape)


def _encode_moment(x: torch.Tensor, dtype: str, role: str = "m"):
    if dtype == "int8":
        if role == "v":
            # second moment in the sqrt domain: linear int8 on v zeroes small
            # entries and the Adam denominator explodes
            return _q8(torch.sqrt(torch.clamp(x, min=0.0)))
        return _q8(x)
    return x.to(getattr(torch, dtype))


def _decode_moment(m, shape, dtype: str, role: str = "m") -> torch.Tensor:
    if dtype == "int8":
        q, s = m
        u = _dq8(q, s, shape)
        if role == "v":
            # floor by one quantization step: bounds the update of entries
            # whose sqrt(v) rounded to zero
            u = torch.maximum(u, _dq8(torch.ones_like(q), s, shape))
            return u * u
        return u
    return m.to(torch.float32)


def _store(dst, new) -> None:
    """Write an encoded moment (a tensor or a (codes, scales) pair) in place."""
    for d, n in zip(dst if isinstance(dst, tuple) else (dst,),
                    new if isinstance(new, tuple) else (new,)):
        d.copy_(n)


# -- init / update ------------------------------------------------------------
def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    def moment(role):
        return tree_map(lambda p: _encode_moment(
            torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            cfg.moments_dtype, role), params)

    device = leaves(params)[0].device
    state: Dict[str, Any] = {"step": torch.zeros((), dtype=torch.int32, device=device),
                             "m": moment("m"), "v": moment("v")}
    master = getattr(torch, cfg.master_dtype) if cfg.master_dtype else None
    if master is not None and any(p.dtype != master for p in leaves(params)):
        state["master"] = tree_map(lambda p: p.detach().to(master, copy=True), params)
    return state


def _stacked_ndims(tree: Any, extra: int = 0) -> list:
    """Each leaf's rank plus one for every list (of groups) above it."""
    if isinstance(tree, dict):
        return [n for v in tree.values() for n in _stacked_ndims(v, extra)]
    if isinstance(tree, list):
        return [n for v in tree for n in _stacked_ndims(v, extra + 1)]
    return [tree.ndim + extra]


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: AdamWConfig) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step, in place: ``params``, ``state``'s moments, masters and
    step are updated and returned.  Metrics: grad_norm and lr (0-d device
    tensors)."""
    state["step"] += 1
    step = state["step"].to(torch.float32)
    lr = schedule(cfg, step)
    gn = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0) if cfg.grad_clip > 0
            else 1.0)
    b1c = 1.0 - torch.pow(cfg.b1, step)
    b2c = 1.0 - torch.pow(cfg.b2, step)
    p_leaves = leaves(params)
    mst_leaves = leaves(state["master"]) if "master" in state else p_leaves
    m_leaves = leaves(state["m"], tuples=False)
    v_leaves = leaves(state["v"], tuples=False)
    for p, ndim, mst, g, m_enc, v_enc in zip(p_leaves, _stacked_ndims(params), mst_leaves,
                                             leaves(grads), m_leaves, v_leaves):
        decay = cfg.weight_decay if ndim >= 2 else 0.0   # no decay on norms
        g32 = g.to(torch.float32) * clip
        m = _decode_moment(m_enc, p.shape, cfg.moments_dtype, "m")
        v = _decode_moment(v_enc, p.shape, cfg.moments_dtype, "v")
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        w = mst.to(torch.float32)
        w = w - lr * (upd + decay * w)
        if mst is not p:
            mst.copy_(w)
        p.copy_(w)
        _store(m_enc, _encode_moment(m, cfg.moments_dtype, "m"))
        _store(v_enc, _encode_moment(v, cfg.moments_dtype, "v"))
    return params, state, {"grad_norm": gn, "lr": lr}
