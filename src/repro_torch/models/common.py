"""Shared LM pieces: norms, activations, embedding (counterpart of the
model-side half of ``repro.models.common``; RoPE comes with attention, and
the mesh helpers have no counterpart on one card)."""
from __future__ import annotations

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
