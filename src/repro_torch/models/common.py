"""Shared LM pieces: the mesh helpers, norms, activations, RoPE, embedding
(counterpart of ``repro.models.common``)."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..core.layers import axis_sizes, exact_dot, lay_out

# Logical mesh axes (launch/mesh.py): batch -> ('pod', 'data'), tensor -> 'model'
BATCH_AXES = ("pod", "data")
TENSOR_AXIS = "model"

_CURRENT_MESH = None


def set_mesh(mesh) -> None:
    """Install the mesh the model serves on (a ``DeviceMesh`` of
    ``launch.mesh``, or None): the launch code calls this; the MoE FFN
    reads it to choose its dispatch path."""
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_mesh():
    return _CURRENT_MESH


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
    is laid out (parameters, decode state), never on activations, which
    every rank holds whole."""
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
