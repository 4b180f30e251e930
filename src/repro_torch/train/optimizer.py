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

On a mesh the parameters are ``core.layers.Sharded`` and so is their state:
masters, moments and codes are laid out as their parameter, the gradients
are this rank's blocks.  The arithmetic is elementwise on the blocks, and
what spans blocks is made the whole array's: the global norm sums each
element once (a split leaf's squares summed over its axes, a replicated
leaf counted once), and an int8 block of 256 that spans ranks takes the
largest magnitude across them, so the codes and scales are the whole
array's, as under the reference's GSPMD.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.layers import Sharded, axis_sizes, local_of, mesh_axes
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


def _last_split(like: Sharded) -> Tuple[Tuple[str, ...], int]:
    """(the axes that split ``like``'s last dim, this rank's first element
    along it)."""
    sizes = axis_sizes(like.mesh)
    axes = tuple(a for a in mesh_axes(like.spec[-1]) if sizes[a] > 1) if like.spec else ()
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + like.mesh.get_local_rank(a)
    return axes, idx * (like.shape[-1] // math.prod(sizes[a] for a in axes) if axes else 0)


def _block_index(x: torch.Tensor, like: Sharded) -> torch.Tensor:
    """The whole array's int8 block of each element along this block's
    last dim."""
    _, off = _last_split(like)
    return torch.div(torch.arange(x.shape[-1], device=x.device) + off, _BLOCK,
                     rounding_mode="floor")


def _q8_laid(x: torch.Tensor, like: Sharded) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_q8`` of the whole array ``like`` lays out, for this rank's block
    ``x`` of it: the codes of the block and the whole last dim's scales of
    its rows.  A block of 256 that spans the ranks splitting the last dim
    takes its largest magnitude across them (``all_reduce`` MAX): the same
    scales, and so the same codes, bit for bit."""
    import torch.distributed as dist
    axes, _ = _last_split(like)
    if not axes:
        return _q8(x)
    blk = _block_index(x, like)
    nb = -(-like.shape[-1] // _BLOCK)
    amax = torch.zeros(*x.shape[:-1], nb, dtype=x.dtype, device=x.device)
    amax.index_reduce_(-1, blk, x.abs(), "amax")
    for a in axes:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=like.mesh.get_group(a))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale[..., blk]), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8_laid(q: torch.Tensor, scale: torch.Tensor, like: Sharded) -> torch.Tensor:
    if not _last_split(like)[0]:
        return _dq8(q, scale, q.shape)
    return q.to(torch.float32) * scale[..., _block_index(q, like)]


def _encode_moment(x: torch.Tensor, dtype: str, role: str = "m", like=None):
    """A float32 moment encoded in ``dtype``; ``like`` (a ``Sharded``
    parameter) when ``x`` is this rank's block of it."""
    if dtype == "int8":
        q8 = _q8 if not isinstance(like, Sharded) else (lambda t: _q8_laid(t, like))
        if role == "v":
            # second moment in the sqrt domain: linear int8 on v zeroes small
            # entries and the Adam denominator explodes
            return q8(torch.sqrt(torch.clamp(x, min=0.0)))
        return q8(x)
    return x.to(getattr(torch, dtype))


def _decode_moment(m, shape, dtype: str, role: str = "m", like=None) -> torch.Tensor:
    if dtype == "int8":
        q, s = (local_of(t) for t in m)
        if isinstance(like, Sharded):
            dq = lambda codes: _dq8_laid(codes, s, like)
        else:
            dq = lambda codes: _dq8(codes, s, shape)
        u = dq(q)
        if role == "v":
            # floor by one quantization step: bounds the update of entries
            # whose sqrt(v) rounded to zero
            u = torch.maximum(u, dq(torch.ones_like(q)))
            return u * u
        return u
    return local_of(m).to(torch.float32)


def _store(dst, new) -> None:
    """Write an encoded moment (a tensor or a (codes, scales) pair) in place."""
    for d, n in zip(dst if isinstance(dst, tuple) else (dst,),
                    new if isinstance(new, tuple) else (new,)):
        local_of(d).copy_(n)


def _laid_like(p, enc):
    """An encoded moment of ``p``'s block laid out as ``p``: its codes as
    the parameter, the scales of an int8 pair with the last dim whole."""
    if not isinstance(p, Sharded):
        return enc
    if not isinstance(enc, tuple):
        return p.like(enc)
    q, s = enc
    return (p.like(q), Sharded(s, p.spec[:-1] + (None,),
                               tuple(p.shape[:-1]) + (-(-p.shape[-1] // _BLOCK),), p.mesh))


# -- init / update ------------------------------------------------------------
def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments and (where a parameter is narrower than
    ``master_dtype``) float32 masters, each laid out as its parameter."""
    def moment(role):
        return tree_map(lambda p: _laid_like(p, _encode_moment(
            torch.zeros(local_of(p).shape, dtype=torch.float32, device=p.device),
            cfg.moments_dtype, role, like=p)), params)

    device = leaves(params)[0].device
    state: Dict[str, Any] = {"step": torch.zeros((), dtype=torch.int32, device=device),
                             "m": moment("m"), "v": moment("v")}
    master = getattr(torch, cfg.master_dtype) if cfg.master_dtype else None
    if master is not None and any(p.dtype != master for p in leaves(params)):
        state["master"] = tree_map(lambda p: _laid_like(
            p, local_of(p).detach().to(master, copy=True)), params)
    return state


def _stacked_ndims(tree: Any, extra: int = 0) -> list:
    """Each leaf's rank plus one for every list (of groups) above it."""
    if isinstance(tree, dict):
        return [n for v in tree.values() for n in _stacked_ndims(v, extra)]
    if isinstance(tree, list):
        return [n for v in tree for n in _stacked_ndims(v, extra + 1)]
    return [tree.ndim + extra]


def global_norm(tree: Any, like: Any = None) -> torch.Tensor:
    """The L2 norm of every element of ``tree``.  With ``like`` (the
    parameters ``tree``'s leaves are the blocks of), a leaf laid out split
    has its sum of squares summed over the axes that split it, and any
    other leaf, whole on every rank, counts once: each element once."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    if like is not None:
        import torch.distributed as dist
        laid = leaves(like)
        groups: Dict[Tuple[str, ...], list] = {}
        for i, p in enumerate(laid):
            if isinstance(p, Sharded) and p.split_axes():
                groups.setdefault(p.split_axes(), []).append(i)
        for axes, idx in groups.items():
            part = torch.stack([sq[i] for i in idx])
            for a in axes:
                dist.all_reduce(part, group=laid[idx[0]].mesh.get_group(a))
            for j, i in enumerate(idx):
                sq[i] = part[j]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: AdamWConfig) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step, in place: ``params``, ``state``'s moments, masters and
    step are updated and returned.  Metrics: grad_norm and lr (0-d device
    tensors)."""
    state["step"] += 1
    step = state["step"].to(torch.float32)
    lr = schedule(cfg, step)
    gn = global_norm(grads, params)
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
        shape = local_of(p).shape
        m = _decode_moment(m_enc, shape, cfg.moments_dtype, "m", like=p)
        v = _decode_moment(v_enc, shape, cfg.moments_dtype, "v", like=p)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        w = local_of(mst).to(torch.float32)
        w = w - lr * (upd + decay * w)
        if mst is not p:
            local_of(mst).copy_(w)
        local_of(p).copy_(w)
        _store(m_enc, _encode_moment(m, cfg.moments_dtype, "m", like=p))
        _store(v_enc, _encode_moment(v, cfg.moments_dtype, "v", like=p))
    return params, state, {"grad_norm": gn, "lr": lr}
