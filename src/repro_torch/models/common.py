"""Shared LM pieces: norms, activations, RoPE, embedding (counterpart of
the model-side half of ``repro.models.common``; the mesh helpers have no
counterpart on one card)."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..core.layers import exact_dot


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
