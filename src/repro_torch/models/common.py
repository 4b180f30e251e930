"""Shared LM pieces: the mesh helpers, norms, activations, RoPE, embedding
(counterpart of ``repro.models.common``)."""
from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F

from ..core.layers import BATCH_AXES, axis_sizes, exact_dot, lay_out

# Logical mesh axes (launch/mesh.py): batch -> ('pod', 'data'), tensor -> 'model'
TENSOR_AXIS = "model"

_CURRENT_MESH = None
# True while a batch's rows are split over the batch axes (training)
_ROWS_SPLIT = False


def set_mesh(mesh) -> None:
    """Install the mesh the model serves on (a ``DeviceMesh`` of
    ``launch.mesh``, or None): the launch code calls this; the MoE FFN
    reads it to choose its dispatch path."""
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_mesh():
    return _CURRENT_MESH


@contextlib.contextmanager
def split_rows():
    """While inside, each rank of the installed mesh holds its own rows of
    the batch (its block over the batch axes), as in training: the loss
    divides by the whole batch's token count and the MoE dispatch takes and
    returns this rank's rows.  Outside (serving), every rank holds every
    row."""
    global _ROWS_SPLIT
    before, _ROWS_SPLIT = _ROWS_SPLIT, True
    try:
        yield
    finally:
        _ROWS_SPLIT = before


def rows_split() -> bool:
    """True inside ``split_rows`` with a mesh installed."""
    return _ROWS_SPLIT and _CURRENT_MESH is not None


def batch_axes(mesh=None) -> tuple:
    """The batch axes of ``mesh`` (default: the installed one) of size > 1,
    the first major."""
    mesh = _CURRENT_MESH if mesh is None else mesh
    if mesh is None:
        return ()
    sizes = axis_sizes(mesh)
    return tuple(a for a in BATCH_AXES if sizes.get(a, 1) > 1)


def batch_size(mesh=None) -> int:
    """Ranks a batch's rows are split over: the product of the batch axes'
    sizes (1 with no mesh)."""
    mesh = _CURRENT_MESH if mesh is None else mesh
    return math.prod(axis_sizes(mesh)[a] for a in batch_axes(mesh)) if mesh is not None else 1


def batch_rank(mesh=None) -> int:
    """This rank's index over the batch axes, the first axis major (0 with
    no mesh): it holds rows [r B / n, (r + 1) B / n) of a batch of B."""
    mesh = _CURRENT_MESH if mesh is None else mesh
    r = 0
    for a in batch_axes(mesh):
        r = r * axis_sizes(mesh)[a] + mesh.get_local_rank(a)
    return r


def all_reduce_batch(t: torch.Tensor, axes=None) -> torch.Tensor:
    """``t`` summed in place over the installed mesh's batch axes of size > 1
    (or ``axes``); with none, ``t`` as is."""
    import torch.distributed as dist
    for a in (batch_axes() if axes is None else axes):
        dist.all_reduce(t, group=_CURRENT_MESH.get_group(a))
    return t


def clean_spec(*spec) -> tuple:
    """A spec with the axes absent from the current mesh dropped."""
    names = set(axis_sizes(_CURRENT_MESH)) if _CURRENT_MESH is not None else set()
    clean = []
    for s in spec:
        if isinstance(s, (tuple, list)):
            keep = tuple(a for a in s if a in names)
            clean.append(keep if keep else None)
        else:
            clean.append(s if s in names else None)
    return tuple(clean)


def shard(x: torch.Tensor, *spec):
    """The explicit layout step for one tensor: with a mesh installed, this
    rank's block of ``x`` as a ``core.layers.Sharded`` (axes absent from
    the mesh or not dividing their dim dropped, as
    ``constrained_sharding`` drops them; nothing left: ``x`` itself); with
    none, the identity.  The
    reference's ``shard`` is a sharding constraint inside a traced
    program; eager PyTorch has none, so the port calls this where a tensor
    is laid out (parameters, decode state), never on activations: serving,
    every rank holds them whole; training, each its own rows."""
    mesh = _CURRENT_MESH
    if mesh is None:
        return x
    return lay_out(x, spec, mesh)


def batch_spec(extra: int = 0) -> tuple:
    """The spec over batch then ``extra`` unsharded dims."""
    return (BATCH_AXES,) + (None,) * extra


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, with the weight stored as (w - 1), the gemma
    convention; the result is cast back to x's dtype."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(torch.float32))).to(x.dtype)


def init_rms_norm(d: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def rope_freqs(hd: int, theta: float, device="cpu") -> torch.Tensor:
    """(hd/2,) float32 inverse frequencies, made once per (hd, theta,
    device): every attention layer's RoPE reads the same table."""
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,) integers.  Angles in
    float32; the rotated halves assembled by stack and reshape, as the
    reference assembles them; the result in x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, float(theta), x.device)
    angles = positions[..., None].to(torch.float32) * freqs    # (B, S, hd/2)
    if angles.ndim == 2:                                        # (S, hd/2)
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : hd // 2], xf[..., hd // 2:]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-2)
    return out.reshape(x.shape).to(x.dtype)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    return table[ids].to(compute_dtype)


def unembed(x: torch.Tensor, table: torch.Tensor, logit_cap: float = 0.0) -> torch.Tensor:
    """Logits through the head (d, vocab): a plain large product, rounded
    as the reference's ``exact_dot`` rounds it in a narrow compute dtype."""
    return softcap(exact_dot(x, table), logit_cap)
