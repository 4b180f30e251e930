"""Mixture-of-Experts FFN on one card (counterpart of ``repro.models.moe``).

The reference has three paths: ``moe_dispatch`` (``shard_map`` with
``all_to_all`` over the batch axes, capacity buffers per destination
shard), ``moe_dense`` (every expert on every token, then the masked
combine) and its plain fallback with no mesh.  On one card ``moe_ffn``
always takes the dense path, as the reference's does with no mesh
installed: the dispatch path and its helpers (``_local_pack``,
``_local_unpack``, ``moe_param_specs``) exist only under a mesh and come
with the scale-out slice of the port (ROADMAP.md item 16).

The experts are plain dense ``(E, d, ff)`` / ``(E, ff, d)`` tensors, never
epitomized (the reference's ``pim.workloads.lm_layers`` lists no expert
site), so their products are ``torch.einsum``s, as the reference's are
``jnp.einsum``s outside any Pallas kernel.  The math is per token: a row's
output depends on its own activation alone.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .common import act_fn
from .config import ModelConfig


def init_moe(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's layout: a float32 ``router`` (d, E); ``w_gate`` and
    ``w_up`` (E, d, ff) and ``w_down`` (E, ff, d) in ``cfg.pdtype``.  Drawn
    on the generator's device expert by expert, each cast to pdtype as it
    is drawn: a float32 copy of a whole expert tensor is 1.68 GB at
    phi3.5-moe's width."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator, device=generator.device) * scale

    def experts(M, N):
        w = torch.empty((E, M, N), dtype=cfg.pdtype, device=device)
        for e in range(E):
            w[e] = randn(M, N, scale=1.0 / math.sqrt(M))
        return w

    router = randn(d, E, scale=1.0 / math.sqrt(d)).to(device=device, dtype=torch.float32)
    return {"router": router, "w_gate": experts(d, ff), "w_up": experts(d, ff),
            "w_down": experts(ff, d)}


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """top-k routing.  x2d: (T, d) -> (weights (T, k) float32, experts (T, k))."""
    logits = x2d.to(torch.float32) @ router
    weights, experts = torch.topk(logits, cfg.top_k, dim=-1)
    return torch.softmax(weights, dim=-1), experts


def moe_dense(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every expert on every token, then the masked combine: x (B, S, d) ->
    (B, S, d) in x's dtype.  The (T, E) combine matrix holds each token's k
    routing weights at its k distinct experts (a scatter, deterministic);
    the expert products run in x's dtype and their weighted sum over E in
    float32.  The reference's three einsums, with the experts on the
    leading (batch) axis: each is one batched matmul over E that reads the
    (E, d, ff) weights where they lie.  (``torch.einsum("td,edf->tef")``
    would make E an output axis of one (T, d) x (d, E ff) product and copy
    both input weights into that layout on every call.)"""
    B, S, d = x.shape
    act = act_fn(cfg.act)
    x2 = x.reshape(-1, d)
    weights, experts = _route(x2, params["router"], cfg)               # (T, k)
    comb = torch.zeros((x2.shape[0], cfg.n_experts), dtype=torch.float32,
                       device=x.device).scatter(1, experts, weights)
    xe = x2.expand(cfg.n_experts, *x2.shape)                           # (E, T, d)
    g = torch.bmm(xe, params["w_gate"].to(x.dtype))
    u = torch.bmm(xe, params["w_up"].to(x.dtype))
    h = act(g) * u                                                     # (E, T, ff)
    del g, u
    o = torch.bmm(h, params["w_down"].to(x.dtype))                     # (E, T, d)
    del h
    y = torch.einsum("etd,te->td", o.to(torch.float32), comb)
    return y.reshape(B, S, d).to(x.dtype)


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Entry point: on one card always the dense path (the reference's
    ``moe_ffn`` with no mesh)."""
    return moe_dense(params, x, cfg)
