"""Full language model: init, prepack, forward, prefill and decode
(counterpart of ``repro.models.lm``).

The reference stacks every group's leaves over a leading group axis and
``lax.scan``s over it.  The port keeps ``params["groups"]`` as a list of
per-group dicts (and the decode state as a list of per-group states) and
loops over them in Python: PyTorch runs eagerly, so a scan buys nothing,
and per-group tensors need no slicing.  ``convert.lm_params_from_jax``
unstacks the reference's tree into this layout.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.layers import EpLayerConfig, prepack_tree
from .blocks import apply_group, decode_group, init_group, init_group_state, prefill_group
from .common import embed_lookup, init_rms_norm, rms_norm, unembed
from .config import ModelConfig
from .ssm import last_real


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` on its own device (a CUDA
    generator draws a full-size model on the card), placed on ``device``."""
    def randn(*shape):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t / math.sqrt(cfg.d_model)).to(device=device, dtype=cfg.pdtype)

    params = {"embed": randn(cfg.vocab, cfg.d_model),
              "groups": [init_group(generator, cfg, device) for _ in range(cfg.n_groups)],
              "final_norm": init_rms_norm(cfg.d_model, cfg.pdtype, device)}
    if not cfg.tie_embeddings:
        params["head"] = randn(cfg.d_model, cfg.vocab)
    return params


def lm_layer_configs(cfg: ModelConfig) -> Dict[str, EpLayerConfig]:
    """Every projection site's EpLayerConfig, keyed by param-tree path,
    enumerated from pim.workloads.lm_layers — the sites init, forward and
    prepack resolve by name."""
    from ..pim.workloads import lm_layers
    return {l.name: cfg.ep(l.rows, l.cols, l.name) for l in lm_layers(cfg)}


def needs_prepack(cfg: ModelConfig) -> bool:
    """True iff any projection runs the fused kernel x quant path."""
    return any(lc.is_epitome and lc.quant is not None and lc.mode == "kernel"
               for lc in lm_layer_configs(cfg).values())


def prepack_params(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Pack every kernel x quant epitome once (int8 codes + per-block scale
    and zero beside E), so every forward feeds the kernel stored codes."""
    configs = lm_layer_configs(cfg)
    with torch.no_grad():
        groups = [prepack_tree(g, configs) for g in params["groups"]]
    return {**params, "groups": groups}


def _embed(params: Dict[str, Any], inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token ids (B, S) -> scaled embeddings; (B, S, d) embeddings (the
    modality stubs' frame or patch inputs) pass through in the compute
    dtype."""
    if inputs.ndim != 2:
        return inputs.to(cfg.cdtype)
    x = embed_lookup(params["embed"], inputs, cfg.cdtype)
    # the scale rounded to the compute dtype first, as jnp.asarray(..., cdtype)
    return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype))


def _logits(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["head"] if "head" in params else params["embed"].T
    return unembed(x, head, cfg.logit_softcap)


def forward(params: Dict[str, Any], inputs: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs: (B, S) int token ids, or (B, S, d) embeddings.  Returns
    logits (B, S, vocab).  ``positions`` ((S,) or (B, S)) place RoPE;
    0..S-1 by default."""
    x = _embed(params, inputs, cfg)
    for group in params["groups"]:
        x = apply_group(group, x, cfg, positions)
    return _logits(params, x, cfg)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> List[Dict[str, Any]]:
    """One decode state per group; ``max_len`` rows of KV cache for each
    attention layer."""
    return [init_group_state(cfg, batch, max_len, device) for _ in range(cfg.n_groups)]


def prefill(params: Dict[str, Any], inputs: torch.Tensor, state: List[Dict[str, Any]],
            cfg: ModelConfig, positions: Optional[torch.Tensor] = None,
            valid_len=None, chunk_start=None) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """Run the prompt ((B, S) ids or (B, S, d) embeddings) and fill the
    decode state.  Returns (last-token logits (B, 1, vocab), new state).
    The attention caches of ``state`` are written in place (the returned
    state holds the same tensors); the recurrent kinds' state is returned
    new.

    ``valid_len`` (an int or a 0-d device tensor) marks a right-padded
    prefill, as the serving engine pads prompts to buckets: only the first
    ``valid_len`` rows are real, the logits are taken at row ``valid_len -
    1`` and the pads leave the recurrent state as the last real token left
    it.  ``chunk_start`` (an int or a 0-d device tensor) makes ``inputs``
    one chunk of a chunked prefill at positions chunk_start +
    arange(S), against a state that carries the earlier chunks (its
    attention caches in float); ``valid_len`` then counts the chunk's real
    rows."""
    x = _embed(params, inputs, cfg)
    new_state = []
    for group, st in zip(params["groups"], state):
        x, st = prefill_group(group, st, x, cfg, positions, valid_len, chunk_start)
        new_state.append(st)
    return _logits(params, last_real(x, valid_len)[:, None], cfg), new_state


def decode_step(params: Dict[str, Any], state: List[Dict[str, Any]], token: torch.Tensor,
                pos, cfg: ModelConfig, page_table=None
                ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """token: (B, 1) int ids or (B, 1, d) embeddings; ``pos`` the token's
    sequence position: an int, or a device tensor, scalar or (B,) per row
    (never read by the host).  Returns (logits (B, 1, vocab), new state);
    the attention caches of ``state`` are written in place at ``pos``.
    ``page_table`` ((B, pages per slot) int, per-row ``pos``): the
    attention caches are the serving engine's block-paged pool
    (``models.kv_pool``), read and written through the table."""
    x = _embed(params, token, cfg)
    new_state = []
    for group, st in zip(params["groups"], state):
        x, st = decode_group(group, st, x, pos, cfg, page_table)
        new_state.append(st)
    return _logits(params, x, cfg), new_state


def decode_scan(params: Dict[str, Any], state: List[Dict[str, Any]], tok: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig, aux: Any,
                sample: Callable, k: int, page_table=None):
    """``k`` decode micro-steps in one call: the serving engine's fused
    macro-step (the reference's ``lax.scan``; here a Python loop that reads
    nothing back from the device, so it can be captured in a CUDA graph).

    ``sample(logits, aux) -> (toks, aux, live)`` is the caller's sampling
    policy: ``logits`` the (B, vocab) rows of this micro-step, ``toks`` the
    (B,) next tokens, ``live`` a (B,) bool device mask of the rows still
    generating.  A row that is not live is frozen: its token and position
    stop advancing (``torch.where`` on the device), so it rewrites the KV
    row it already owns; its recurrent state runs on into garbage that the
    next admission overwrites.  ``tok`` (B, 1) and ``pos`` (B,) are device
    tensors.  ``page_table`` is the same for every micro-step: admission
    maps every page a request will touch.

    Returns (state, tok, pos, aux, toks (k, B), live (k, B))."""
    toks, lives = [], []
    for _ in range(k):
        logits, state = decode_step(params, state, tok, pos, cfg, page_table)
        nxt, aux, live = sample(logits[:, -1], aux)
        tok = torch.where(live[:, None], nxt[:, None].to(tok.dtype), tok)
        pos = torch.where(live, pos + 1, pos)
        toks.append(nxt)
        lives.append(live)
    return state, tok, pos, aux, torch.stack(toks), torch.stack(lives)
