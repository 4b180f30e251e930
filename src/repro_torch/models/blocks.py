"""Decoder blocks: one "group" is the smallest repeating super-block of a
model (counterpart of ``repro.models.blocks``).  lm.py keeps one parameter
dict per group and loops over them.

The port runs every layer kind of the reference: the attention kinds
(``attn``, sliding-window ``attn_local``), Mamba (``mamba``, jamba's SSM
layer) and the RWKV6 kinds (the ``rwkv`` mixer and the ``rwkv_ffn``
channel mix), with the dense SwiGLU/gelu FFN or the MoE FFN
(``models.moe``).

Prefill and decode update the attention caches of the state they are given
in place (and return them in the new state); the recurrent kinds return new
state tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..core.layers import apply_linear, init_linear
from .attention import (CacheSpec, attention, chunked_prefill_attention,
                        decode_attention, init_attn, init_kv_cache, quantize_kv)
from .common import act_fn, init_rms_norm, rms_norm
from .config import LayerKind, ModelConfig, layer_name as _nm
from .moe import init_moe, moe_ffn
from .ssm import (init_mamba, init_mamba_state, init_rwkv, init_rwkv_ffn, init_rwkv_state,
                  mamba_mix, rwkv_channel_mix, rwkv_time_mix)

_ATTN = (LayerKind.ATTN.value, LayerKind.ATTN_LOCAL.value)
_MAMBA = LayerKind.MAMBA.value
_MIXERS = _ATTN + (_MAMBA, LayerKind.RWKV.value)
_FFNS = ("dense", "moe", "rwkv_ffn", "none")


def _check_kinds(cfg: ModelConfig) -> None:
    for kind, ffn_kind in cfg.full_pattern:
        if kind not in _MIXERS or ffn_kind not in _FFNS:
            raise ValueError(f"{cfg.name}: unknown layer kinds {(kind, ffn_kind)}")


# ---------------------------------------------------------------------------
# FFN (SwiGLU / gelu-MLP; the MoE FFN in models.moe)
# ---------------------------------------------------------------------------
def init_ffn(generator: torch.Generator, cfg: ModelConfig, prefix: str = "",
             device="cuda") -> dict:
    d, ff = cfg.d_model, cfg.d_ff

    def lin(w, M, N):
        return init_linear(generator, M, N, cfg.ep(M, N, _nm(prefix, w)),
                           dtype=cfg.pdtype, device=device)
    return {"w_gate": lin("w_gate", d, ff), "w_up": lin("w_up", d, ff),
            "w_down": lin("w_down", ff, d)}


def ffn(params: dict, x: torch.Tensor, cfg: ModelConfig, prefix: str = "") -> torch.Tensor:
    d, ff = cfg.d_model, cfg.d_ff
    g = apply_linear(params["w_gate"], x, cfg.ep(d, ff, _nm(prefix, "w_gate")))
    u = apply_linear(params["w_up"], x, cfg.ep(d, ff, _nm(prefix, "w_up")))
    h = act_fn(cfg.act)(g) * u
    return apply_linear(params["w_down"], h, cfg.ep(ff, d, _nm(prefix, "w_down")))


def _ffn(layer: Dict[str, Any], x: torch.Tensor, ffn_kind: str, cfg: ModelConfig,
         prefix: str, x_prev: Optional[torch.Tensor] = None, valid_len=None):
    """The FFN half of a layer, residual included: (x, the channel mix's
    last real token, or None for the dense and MoE FFNs)."""
    h = rms_norm(x, layer["norm2"], cfg.norm_eps)
    if ffn_kind == "dense":
        return x + ffn(layer["ffn"], h, cfg, prefix=prefix), None
    if ffn_kind == "moe":
        return x + moe_ffn(layer["ffn"], h, cfg), None
    if x_prev is not None:
        x_prev = x_prev.to(h.dtype)
    f, xp = rwkv_channel_mix(layer["ffn"], h, cfg, x_prev=x_prev, prefix=prefix,
                             valid_len=valid_len)
    return x + f, xp


# ---------------------------------------------------------------------------
# One group (super-block)
# ---------------------------------------------------------------------------
def init_group(generator: torch.Generator, cfg: ModelConfig,
               device="cuda") -> Dict[str, Any]:
    _check_kinds(cfg)
    params: Dict[str, Any] = {}
    for i, (kind, ffn_kind) in enumerate(cfg.full_pattern):
        mixer_p, ffn_p = f"L{i}/mixer", f"L{i}/ffn"
        layer: Dict[str, Any] = {"norm1": init_rms_norm(cfg.d_model, cfg.pdtype, device)}
        if kind in _ATTN:
            layer["mixer"] = init_attn(generator, cfg, prefix=mixer_p, device=device)
        elif kind == _MAMBA:
            layer["mixer"] = init_mamba(generator, cfg, prefix=mixer_p, device=device)
        else:
            layer["mixer"] = init_rwkv(generator, cfg, prefix=mixer_p, device=device)
        if ffn_kind != "none":
            layer["norm2"] = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        if ffn_kind == "dense":
            layer["ffn"] = init_ffn(generator, cfg, prefix=ffn_p, device=device)
        elif ffn_kind == "moe":
            layer["ffn"] = init_moe(generator, cfg, device=device)
        elif ffn_kind == "rwkv_ffn":
            layer["ffn"] = init_rwkv_ffn(generator, cfg, prefix=ffn_p, device=device)
        params[f"L{i}"] = layer
    return params


def apply_group(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / prefill forward through one super-block, from zero state;
    ``positions`` ((S,) or (B, S)) place the attention kinds' RoPE."""
    _check_kinds(cfg)
    for i, (kind, ffn_kind) in enumerate(cfg.full_pattern):
        layer = params[f"L{i}"]
        mixer_p = f"L{i}/mixer"
        h = rms_norm(x, layer["norm1"], cfg.norm_eps)
        if kind in _ATTN:
            mix = attention(layer["mixer"], h, cfg, local=kind == LayerKind.ATTN_LOCAL.value,
                            positions=positions, prefix=mixer_p)
        elif kind == _MAMBA:
            mix, _ = mamba_mix(layer["mixer"], h, cfg, prefix=mixer_p)
        else:
            mix, _ = rwkv_time_mix(layer["mixer"], h, cfg, prefix=mixer_p)
        x = x + mix
        if ffn_kind != "none":
            x, _ = _ffn(layer, x, ffn_kind, cfg, f"L{i}/ffn")
    return x


def prefill_group(params: Dict[str, Any], state: Dict[str, Any], x: torch.Tensor,
                  cfg: ModelConfig, positions: Optional[torch.Tensor] = None,
                  valid_len=None, chunk_start=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence forward that also fills the decode state: the prompt's
    K/V (or their int8 codes and scales) are written in place at row 0 of
    the state's preallocated caches; the recurrent kinds carry their
    state.

    ``valid_len`` (an int or a 0-d device tensor) marks a right-padded
    prefill (the serving engine's buckets): only the first ``valid_len``
    rows are real.  The recurrent kinds mask the pads out of their state;
    attention needs no mask, since pad K/V lie past every real query and
    decode overwrites them before a mask lets them through.

    ``chunk_start`` makes x one chunk of a chunked prefill, at sequence
    rows chunk_start.. (``valid_len`` then counts its real rows): the
    attention kinds write the chunk's K/V into the state's float cache at
    those rows and attend over it (``chunked_prefill_attention``); the
    recurrent kinds need nothing more, their carried state is their past."""
    _check_kinds(cfg)
    new_state: Dict[str, Any] = {}
    for i, (kind, ffn_kind) in enumerate(cfg.full_pattern):
        layer, st = params[f"L{i}"], state[f"L{i}"]
        ns = dict(st)
        mixer_p = f"L{i}/mixer"
        h = rms_norm(x, layer["norm1"], cfg.norm_eps)
        if kind in _ATTN and chunk_start is not None:
            mix, _ = chunked_prefill_attention(
                layer["mixer"], h, st, chunk_start, cfg,
                local=kind == LayerKind.ATTN_LOCAL.value, valid_len=valid_len,
                prefix=mixer_p)
        elif kind in _ATTN:
            mix, (k, v) = attention(layer["mixer"], h, cfg,
                                    local=kind == LayerKind.ATTN_LOCAL.value,
                                    positions=positions, return_kv=True, prefix=mixer_p)
            S = k.shape[1]
            if cfg.kv_cache_bits == 8:
                (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
                written = (("k", kq), ("k_s", ks), ("v", vq), ("v_s", vs))
            else:
                written = (("k", k), ("v", v))
            for name, t in written:
                st[name][:, :S].copy_(t)
        elif kind == _MAMBA:
            mix, (conv, hst) = mamba_mix(layer["mixer"], h, cfg,
                                         state=(st["conv"].to(h.dtype), st["h"]),
                                         prefix=mixer_p, valid_len=valid_len)
            ns["conv"], ns["h"] = conv.to(st["conv"].dtype), hst
        else:
            mix, (xp, s) = rwkv_time_mix(layer["mixer"], h, cfg,
                                         state=(st["x_prev"].to(h.dtype), st["s"]),
                                         prefix=mixer_p, valid_len=valid_len)
            ns["x_prev"], ns["s"] = xp.to(st["x_prev"].dtype), s
        x = x + mix
        if ffn_kind != "none":
            x, xp2 = _ffn(layer, x, ffn_kind, cfg, f"L{i}/ffn", st.get("ffn_x_prev"),
                          valid_len)
            if xp2 is not None:
                ns["ffn_x_prev"] = xp2.to(cfg.cdtype)
        new_state[f"L{i}"] = ns
    return x, new_state


def init_group_state(cfg: ModelConfig, batch: int, max_len: int,
                     device="cuda") -> Dict[str, Any]:
    """Decode state for one group: for the attention kinds a KV cache of
    ``max_len`` rows, for Mamba and the RWKV kinds the recurrent state."""
    _check_kinds(cfg)
    state: Dict[str, Any] = {}
    for i, (kind, ffn_kind) in enumerate(cfg.full_pattern):
        if kind in _ATTN:
            c = init_kv_cache(cfg, CacheSpec(max_len=max_len, batch=batch), n=1,
                              device=device)
            state[f"L{i}"] = {k: v[0] for k, v in c.items()}
        elif kind == _MAMBA:
            conv, h = init_mamba_state(cfg, batch, device)
            state[f"L{i}"] = {"conv": conv, "h": h}
        else:
            xp, s = init_rwkv_state(cfg, batch, device)
            state[f"L{i}"] = {"x_prev": xp, "s": s}
            if ffn_kind == "rwkv_ffn":
                state[f"L{i}"]["ffn_x_prev"] = torch.zeros(
                    (batch, cfg.d_model), dtype=cfg.cdtype, device=device)
    return state


def decode_group(params: Dict[str, Any], state: Dict[str, Any], x: torch.Tensor,
                 pos, cfg: ModelConfig, page_table=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """x: (B, 1, d); ``pos`` the token's position (an int, or a device
    tensor, scalar or (B,)), where the attention kinds write their cache in
    place.  Returns (x, new state).  With ``page_table`` ((B, pages per
    slot), per-row ``pos``) the attention kinds' k/v are the serving
    engine's block-paged pool (``models.kv_pool``), read and written
    through the table; the recurrent rows stay dense either way."""
    _check_kinds(cfg)
    new_state: Dict[str, Any] = {}
    for i, (kind, ffn_kind) in enumerate(cfg.full_pattern):
        layer, st = params[f"L{i}"], state[f"L{i}"]
        ns = dict(st)
        mixer_p = f"L{i}/mixer"
        h = rms_norm(x, layer["norm1"], cfg.norm_eps)
        if kind in _ATTN:
            mix, _ = decode_attention(layer["mixer"], h, st, pos, cfg,
                                      local=kind == LayerKind.ATTN_LOCAL.value,
                                      page_table=page_table, prefix=mixer_p)
        elif kind == _MAMBA:
            mix, (conv, hst) = mamba_mix(layer["mixer"], h, cfg, state=(st["conv"], st["h"]),
                                         prefix=mixer_p)
            ns["conv"], ns["h"] = conv, hst
        else:
            mix, (xp, s) = rwkv_time_mix(layer["mixer"], h, cfg,
                                         state=(st["x_prev"].to(h.dtype), st["s"]),
                                         prefix=mixer_p)
            ns["x_prev"], ns["s"] = xp.to(cfg.cdtype), s
        x = x + mix
        if ffn_kind != "none":
            x, xp2 = _ffn(layer, x, ffn_kind, cfg, f"L{i}/ffn", st.get("ffn_x_prev"))
            if xp2 is not None:
                ns["ffn_x_prev"] = xp2.to(cfg.cdtype)
        new_state[f"L{i}"] = ns
    return x, new_state
