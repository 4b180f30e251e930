"""Decoder blocks: one "group" is the smallest repeating super-block of a
model (counterpart of ``repro.models.blocks``).  lm.py keeps one parameter
dict per group and loops over them.

The port runs the RWKV6 layer kinds: the ``rwkv`` mixer and the ``rwkv_ffn``
channel mix.  Attention, Mamba and the dense and MoE FFNs come with later
slices and raise here until then.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .common import init_rms_norm, rms_norm
from .config import LayerKind, ModelConfig
from .ssm import (init_rwkv, init_rwkv_ffn, init_rwkv_state, rwkv_channel_mix,
                  rwkv_time_mix)

_LATER = {
    LayerKind.ATTN.value: "the attention slice",
    LayerKind.ATTN_LOCAL.value: "the attention slice",
    LayerKind.MAMBA.value: "the Mamba slice",
    "dense": "the attention slice (dense SwiGLU/gelu FFN)",
    "moe": "the MoE slice",
}


def _check_kinds(cfg: ModelConfig) -> None:
    for kind, ffn_kind in cfg.full_pattern:
        for k in (kind, ffn_kind):
            if k in _LATER:
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {k!r} is not ported yet; it comes "
                    f"with {_LATER[k]} of the port (ROADMAP.md)")
        if kind != LayerKind.RWKV.value or ffn_kind not in ("rwkv_ffn", "none"):
            raise ValueError(f"{cfg.name}: unknown layer kinds {(kind, ffn_kind)}")


def init_group(generator: torch.Generator, cfg: ModelConfig,
               device="cuda") -> Dict[str, Any]:
    _check_kinds(cfg)
    params: Dict[str, Any] = {}
    for i, (_, ffn_kind) in enumerate(cfg.full_pattern):
        layer: Dict[str, Any] = {
            "norm1": init_rms_norm(cfg.d_model, cfg.pdtype, device),
            "mixer": init_rwkv(generator, cfg, prefix=f"L{i}/mixer", device=device)}
        if ffn_kind != "none":
            layer["norm2"] = init_rms_norm(cfg.d_model, cfg.pdtype, device)
            layer["ffn"] = init_rwkv_ffn(generator, cfg, prefix=f"L{i}/ffn",
                                         device=device)
        params[f"L{i}"] = layer
    return params


def apply_group(params: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Training / prefill forward through one super-block, from zero state."""
    _check_kinds(cfg)
    for i, (_, ffn_kind) in enumerate(cfg.full_pattern):
        layer = params[f"L{i}"]
        h = rms_norm(x, layer["norm1"], cfg.norm_eps)
        mix, _ = rwkv_time_mix(layer["mixer"], h, cfg, prefix=f"L{i}/mixer")
        x = x + mix
        if ffn_kind == "none":
            continue
        h = rms_norm(x, layer["norm2"], cfg.norm_eps)
        f, _ = rwkv_channel_mix(layer["ffn"], h, cfg, prefix=f"L{i}/ffn")
        x = x + f
    return x


def _step_group(params: Dict[str, Any], state: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One group over x (a prompt or one token) from ``state``; returns the
    new state beside the output.  Prefill and decode differ only in S."""
    _check_kinds(cfg)
    new_state: Dict[str, Any] = {}
    for i, (_, ffn_kind) in enumerate(cfg.full_pattern):
        layer, st = params[f"L{i}"], state[f"L{i}"]
        ns = dict(st)
        h = rms_norm(x, layer["norm1"], cfg.norm_eps)
        mix, (xp, s) = rwkv_time_mix(layer["mixer"], h, cfg,
                                     state=(st["x_prev"].to(h.dtype), st["s"]),
                                     prefix=f"L{i}/mixer")
        ns["x_prev"], ns["s"] = xp.to(st["x_prev"].dtype), s
        x = x + mix
        if ffn_kind != "none":
            h = rms_norm(x, layer["norm2"], cfg.norm_eps)
            f, xp2 = rwkv_channel_mix(layer["ffn"], h, cfg,
                                      x_prev=st["ffn_x_prev"].to(h.dtype),
                                      prefix=f"L{i}/ffn")
            ns["ffn_x_prev"] = xp2.to(cfg.cdtype)
            x = x + f
        new_state[f"L{i}"] = ns
    return x, new_state


def prefill_group(params: Dict[str, Any], state: Dict[str, Any], x: torch.Tensor,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence forward that also fills the decode state."""
    return _step_group(params, state, x, cfg)


def init_group_state(cfg: ModelConfig, batch: int, max_len: int,
                     device="cuda") -> Dict[str, Any]:
    """Decode state for one group.  ``max_len`` sizes attention caches,
    which the RWKV kinds do not have."""
    _check_kinds(cfg)
    state: Dict[str, Any] = {}
    for i, (_, ffn_kind) in enumerate(cfg.full_pattern):
        xp, s = init_rwkv_state(cfg, batch, device)
        state[f"L{i}"] = {"x_prev": xp, "s": s}
        if ffn_kind == "rwkv_ffn":
            state[f"L{i}"]["ffn_x_prev"] = torch.zeros(
                (batch, cfg.d_model), dtype=cfg.cdtype, device=device)
    return state


def decode_group(params: Dict[str, Any], state: Dict[str, Any], x: torch.Tensor,
                 pos, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """x: (B, 1, d).  Returns (x, new state).  ``pos`` positions attention
    caches; the recurrent kinds carry their past in the state alone."""
    return _step_group(params, state, x, cfg)
