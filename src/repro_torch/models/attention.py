"""Attention: GQA, RoPE, the chunked online softmax, sliding windows,
softcapping (gemma2); prefill and decode paths (counterpart of
``repro.models.attention``).

Plain PyTorch, op for op the reference's: the prefill walks the KV chunks
with an online softmax, so a long prompt never holds an (S x S) score
matrix; ``NEG_INF`` is finite and masked probabilities are zeroed
explicitly, so a fully masked row stays NaN-free.  No library attention is
used: it would not reproduce the reference's chunked sums, its finite
``NEG_INF`` or its softcap.

The decode caches are preallocated (``init_kv_cache``) and written in place
at the step's position (a Python int or a device tensor, never read back by
the host), so a decode step copies no cache and can be captured in a CUDA
graph.  ``kv_cache_spec`` is a cache's layout on a mesh
(``lm.state_specs``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.layers import apply_linear, init_linear
from .common import apply_rope, softcap
from .config import ModelConfig, layer_name as _nm

NEG_INF = -2.0 ** 30   # large-but-finite: keeps fully-masked rows NaN-free


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a 0-d tensor of ``like``'s dtype on its device, to
    divide by as the CPU and the reference divide (see quantize_kv)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_attn(generator: torch.Generator, cfg: ModelConfig, prefix: str = "",
              device="cuda") -> dict:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.pdtype

    def lin(w, M, N, bias):
        return init_linear(generator, M, N, cfg.ep(M, N, _nm(prefix, w)), bias=bias,
                           dtype=dt, device=device)
    return {"wq": lin("wq", d, nq * hd, cfg.qkv_bias),
            "wk": lin("wk", d, nkv * hd, cfg.qkv_bias),
            "wv": lin("wv", d, nkv * hd, cfg.qkv_bias),
            "wo": lin("wo", nq * hd, d, False)}


def _qkv(params: dict, x: torch.Tensor, cfg: ModelConfig, prefix: str):
    """The three input projections, (B, S, heads, hd) each."""
    B, S, d = x.shape
    hd, nq, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = apply_linear(params["wq"], x, cfg.ep(d, nq * hd, _nm(prefix, "wq")))
    k = apply_linear(params["wk"], x, cfg.ep(d, nkv * hd, _nm(prefix, "wk")))
    v = apply_linear(params["wv"], x, cfg.ep(d, nkv * hd, _nm(prefix, "wv")))
    return q.reshape(B, S, nq, hd), k.reshape(B, S, nkv, hd), v.reshape(B, S, nkv, hd)


def _out(params: dict, o: torch.Tensor, cfg: ModelConfig, prefix: str) -> torch.Tensor:
    nqhd = cfg.n_heads * cfg.hd
    return apply_linear(params["wo"], o, cfg.ep(nqhd, cfg.d_model, _nm(prefix, "wo")))


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention — prefill
# ---------------------------------------------------------------------------
def _chunk_attn(q, k, v, q_offset, kv_chunk: int, causal: bool,
                window: Optional[int], cap: float) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``kv_chunk`` rows.

    q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd), H = G * Hkv, query head h
    reading KV head h // G.  ``q_offset`` (an int or a 0-d tensor) is the
    first query's sequence position.  Returns (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    nchunks = -(-Skv // kv_chunk)
    pad = nchunks * kv_chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    if G > 1:   # GQA: every KV head repeated to its G query heads up front
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    dev = q.device
    qf = q.to(torch.float32)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=dev)
    for start in range(0, nchunks * kv_chunk, kv_chunk):
        kc = k[:, start:start + kv_chunk].to(torch.float32)
        vc = v[:, start:start + kv_chunk].to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kc) * scale
        s = softcap(s, cap)
        kv_pos = start + torch.arange(kv_chunk, device=dev)
        mask = (kv_pos[None, :] < Skv).expand(Sq, kv_chunk)   # in bounds (padding)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None and window > 0:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        mask = mask[None, :, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        # zero masked entries explicitly: a fully-masked chunk would
        # otherwise contribute exp(0) = 1 everywhere
        p = p * mask
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, vc)
        m = m_new
    o = o / torch.clamp_min(l[..., None], 1e-30)
    return o.to(q.dtype)


def attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              local: bool = False, positions: Optional[torch.Tensor] = None,
              kv_chunk: int = 0, return_kv: bool = False, prefix: str = ""):
    """Full-sequence causal attention (prefill).  x: (B, S, d); with
    ``return_kv`` also the roped K and V, (B, S, Hkv, hd) each."""
    kv_chunk = kv_chunk or cfg.attn_kv_chunk
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(params, x, cfg, prefix)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if local else None
    o = _chunk_attn(q, k, v, 0, min(kv_chunk, S), True, window, cfg.attn_softcap)
    out = _out(params, o.reshape(B, S, cfg.n_heads * cfg.hd), cfg, prefix)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# Decode path (one new token against a KV cache)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static decode-cache geometry."""
    max_len: int
    batch: int


def init_kv_cache(cfg: ModelConfig, spec: CacheSpec, n: int = 1,
                  device="cuda") -> dict:
    """n stacked caches (B, max_len, Hkv, hd) in the compute dtype, or at
    kv_cache_bits=8 int8 codes with one fp16 scale per (token, head)."""
    shp = (n, spec.batch, spec.max_len, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_cache_bits == 8:
        sshp = shp[:-1] + (1,)
        zeros = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
        return {"k": zeros(shp, torch.int8), "v": zeros(shp, torch.int8),
                "k_s": zeros(sshp, torch.float16), "v_s": zeros(sshp, torch.float16)}
    return {"k": torch.zeros(shp, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shp, dtype=cfg.cdtype, device=device)}


def kv_cache_spec(batch_axes, seq_axes) -> tuple:
    """The spec of one layer's cache (B, S, Hkv, hd): the reference's, whose
    cache has a leading layers axis more."""
    return (batch_axes, seq_axes, None, None)


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, hd) -> int8 codes + per-(token, head) fp16 scale.  The divisor
    is a tensor: CUDA would turn a Python scalar divisor into a product by
    its reciprocal, one ulp off the CPU's scale (and codes)."""
    s = t.abs().amax(dim=-1, keepdim=True) / _scalar(127.0, t) + 1e-8
    q = torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)
    return q, s.to(torch.float16)


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * s.to(torch.float32)).to(dtype)


def chunked_prefill_attention(params: dict, x: torch.Tensor, cache: dict,
                              chunk_start, cfg: ModelConfig, *, local: bool = False,
                              valid_len=None, prefix: str = "") -> Tuple[torch.Tensor, dict]:
    """One prefill chunk against a running dense float cache.

    x: (B, C, d), the chunk's embeddings; cache k/v: (B, Smax, Hkv, hd)
    holding every earlier chunk's K/V; ``chunk_start`` (an int or a 0-d
    tensor) the chunk's first row.  Writes the chunk's K/V into the cache
    in place at chunk_start and attends the chunk's queries over the whole
    cache with the one-shot path's online softmax (rows past the chunk are
    causally masked).  Pad rows of a final partial chunk (``valid_len``)
    need no masking: their outputs are discarded and their K/V rows lie
    where the causal mask hides them until decode overwrites them."""
    if cfg.kv_cache_bits == 8:
        raise NotImplementedError(
            "chunked prefill requires a float KV cache (kv_cache_bits=16)")
    B, C, _ = x.shape
    Smax = cache["k"].shape[1]
    positions = chunk_start + torch.arange(C, device=x.device)
    q, k, v = _qkv(params, x, cfg, prefix)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    rows = positions.to(torch.long)
    cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
    window = cfg.window if local else None
    o = _chunk_attn(q, cache["k"], cache["v"], chunk_start,
                    min(cfg.attn_kv_chunk, Smax), True, window, cfg.attn_softcap)
    return _out(params, o.reshape(B, C, cfg.n_heads * cfg.hd), cfg, prefix), cache


def decode_attention(params: dict, x: torch.Tensor, cache: dict, pos,
                     cfg: ModelConfig, *, local: bool = False,
                     page_table: Optional[torch.Tensor] = None,
                     prefix: str = "") -> Tuple[torch.Tensor, dict]:
    """One decode step.  x: (B, 1, d); cache {k, v[, k_s, v_s]} with k/v
    (B, Smax, Hkv, hd); ``pos`` the write row: a Python int, a 0-d tensor,
    or a (B,) tensor of per-row rows.  The step's K/V (or their int8 codes
    and scales) are written into the cache in place; returns (out, cache).

    ``page_table`` (B, pages_per_slot; per-row ``pos``): k/v are a global
    pool of pages (num_pages + trash, page_size, Hkv, hd), the step lands
    at the physical row its table maps ``pos`` to, and each row's pages are
    gathered back into a dense (B, Lg, Hkv, hd) view.  Rows gathered from
    unmapped pages may hold garbage, even NaN: V is zeroed under the mask,
    so it cannot reach the output."""
    B = x.shape[0]
    hd, nq, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    G = nq // nkv
    dev = x.device
    per_row = isinstance(pos, torch.Tensor) and pos.ndim == 1
    paged = page_table is not None
    if paged:
        if not per_row:
            raise ValueError("page_table requires per-row (B,) positions")
        page = cache["k"].shape[1]
        Smax = page_table.shape[1] * page          # gathered rows per slot
    else:
        Smax = cache["k"].shape[1]
    q, k, v = _qkv(params, x, cfg, prefix)
    if per_row:
        posv = pos[:, None]
    elif isinstance(pos, torch.Tensor):
        posv = pos.reshape(1)
    else:
        posv = torch.full((1,), pos, dtype=torch.int32, device=dev)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    if paged:
        # physical row of each slot's current token, then one flat write
        table, pos_l = page_table.to(torch.long), pos.to(torch.long)
        phys = torch.gather(table, 1, (pos_l // page)[:, None])[:, 0]
        flat = phys * page + pos_l % page                          # (B,)

        def upd(c, t):
            c.view((-1,) + c.shape[2:]).index_copy_(0, flat, t[:, 0].to(c.dtype))

        full = lambda c: c[table].reshape((B, Smax) + c.shape[2:])
    elif per_row:
        rows = torch.arange(B, device=dev)

        def upd(c, t):
            c.index_put_((rows, pos.to(torch.long)), t[:, 0].to(c.dtype))

        full = lambda c: c
    else:
        def upd(c, t):
            c.index_copy_(1, posv.to(torch.long), t.to(c.dtype))

        full = lambda c: c
    if cfg.kv_cache_bits == 8:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for name, t in (("k", kq), ("k_s", ks), ("v", vq), ("v_s", vs)):
            upd(cache[name], t)
        kc = dequantize_kv(full(cache["k"]), full(cache["k_s"]), torch.float32)
        vc = dequantize_kv(full(cache["v"]), full(cache["v_s"]), torch.float32)
    else:
        upd(cache["k"], k)
        upd(cache["v"], v)
        kc = full(cache["k"]).to(torch.float32)
        vc = full(cache["v"]).to(torch.float32)

    qg = q.reshape(B, nkv, G, hd).to(torch.float32)
    s = torch.einsum("bhgd,bshd->bhgs", qg, kc) / _scalar(math.sqrt(hd), qg)
    s = softcap(s, cfg.attn_softcap)
    kv_pos = torch.arange(Smax, device=dev)
    at = pos[:, None] if per_row else pos
    rmask = kv_pos[None, :] <= at                         # (B or 1, Smax)
    if local and cfg.window:
        rmask = rmask & (kv_pos[None, :] > at - cfg.window)
    # masked rows get exact-zero probability by exp underflow at NEG_INF,
    # but 0 * NaN = NaN: V is zeroed under the mask, so garbage rows (an
    # unmapped page, a freed slot's scribbles) never reach the output
    vc = torch.where(rmask[..., None, None], vc, 0.0)
    s = torch.where(rmask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, vc)
    o = o.reshape(B, 1, nq * hd).to(x.dtype)
    return _out(params, o, cfg, prefix), cache
