"""Sequence-state models: RWKV6 (Finch) time and channel mixing, and
Mamba's selective SSM, jamba's (counterpart of ``repro.models.ssm``).

Data-dependent per-channel decay (arXiv:2404.05892), per head:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (K x K state)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
A prefill runs the chunked form through ``kernels.ops.wkv6`` (the CUDA
kernel on the card, its plain version on the CPU); a decode step (one
token) is the plain recurrence, as in the reference, which runs no kernel
there.

Mamba (arXiv:2312.00752, as used in jamba): input-dependent (dt, B, C)
through a causal depthwise conv and two projections, then the selective
scan through ``kernels.ops.mamba_scan`` (the CUDA kernel on the card, its
plain version on the CPU) for a prefill and a decode step alike.

A right-padded prefill (``valid_len``, the serving engine's bucketed and
chunked prefills) masks its pad rows so they leave the carried state as
the last real token left it, and carries the last real token's x (RWKV)
or conv window (Mamba).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.layers import apply_linear, init_linear
from ..kernels import ops
from .config import ModelConfig, layer_name as _nm


def recurrence_alignment(cfg: ModelConfig) -> int:
    """Smallest chunk granularity at which a prefill can be split without
    changing any recurrent layer's bits: a common multiple of every
    recurrence's internal window (cfg.rwkv_chunk / cfg.mamba_chunk), since
    state carried across a window boundary goes through non-associative
    float arithmetic.  Attention-only stacks may split anywhere (1)."""
    align = 1
    for kind, _ in cfg.full_pattern:
        if kind == "mamba":
            align = math.lcm(align, cfg.mamba_chunk)
        elif kind == "rwkv":
            align = math.lcm(align, cfg.rwkv_chunk)
    return align


def _randn(generator: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def init_rwkv(generator: torch.Generator, cfg: ModelConfig, prefix: str = "",
              device="cuda") -> dict:
    d, H = cfg.d_model, cfg.n_heads
    K = d // H
    dt = cfg.pdtype
    lm, ld = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    put = lambda t: t.to(device=device, dtype=dt)
    full = lambda shape, v: torch.full(shape, v, dtype=dt, device=device)
    lin = lambda w: init_linear(generator, d, d, cfg.ep(d, d, _nm(prefix, w)),
                                dtype=dt, device=device)
    return {
        # token-shift mix coefficients (x, r, k, v, w, g)
        "mu": full((6, d), 0.5),
        # ddlerp LoRAs: 5 targets (r, k, v, w, g)
        "lora_A": put(_randn(generator, 5, d, lm) / math.sqrt(d)),
        "lora_B": full((5, lm, d), 0.0),
        # decay: w0 + tanh(x W_a) W_b
        "w0": full((d,), -1.0),
        "wd_A": put(_randn(generator, d, ld) / math.sqrt(d)),
        "wd_B": full((ld, d), 0.0),
        "u": put(_randn(generator, H, K) * 0.1),
        "wr": lin("wr"), "wk": lin("wk"), "wv": lin("wv"), "wg": lin("wg"),
        "wo": lin("wo"),
        "ln_x": full((d,), 1.0),
    }


def _shifted(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: the previous token minus this one, (B, S, d)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1) - x


def _rwkv_inputs(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                 cfg: ModelConfig, prefix: str = ""):
    """Token-shift ddlerp producing (r, k, v, g, logw), all (B, S, d).
    x_prev: (B, d) last token of the previous chunk/step."""
    d = x.shape[-1]
    xx = _shifted(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xxx = x + xx * mu[0]
    lora = torch.einsum(
        "fbsl,fld->fbsd",
        torch.tanh(torch.einsum("bsd,fdl->fbsl", xxx, p["lora_A"].to(x.dtype))),
        p["lora_B"].to(x.dtype))
    xr, xk, xv, xw, xg = (x + xx * (mu[i + 1] + lora[i]) for i in range(5))
    ep = lambda w: cfg.ep(d, d, _nm(prefix, w))
    r = apply_linear(p["wr"], xr, ep("wr"))
    k = apply_linear(p["wk"], xk, ep("wk"))
    v = apply_linear(p["wv"], xv, ep("wv"))
    g = F.silu(apply_linear(p["wg"], xg, ep("wg")))
    logw = -torch.exp(p["w0"].to(torch.float32)
                      + torch.tanh(xw.to(torch.float32) @ p["wd_A"].to(torch.float32))
                      @ p["wd_B"].to(torch.float32))            # (B, S, d), <= 0
    return r, k, v, g, logw


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    B, S, d = t.shape
    return t.reshape(B, S, H, d // H)


def rwkv_chunked(r, k, v, logw, u, state, chunk: int = 64):
    """Chunked WKV.  r/k/v/logw: (B, S, H, K), logw <= 0; u: (H, K);
    state: (B, H, K, K).  Returns (out (B, S, H, K) float32, new state)."""
    return ops.wkv6(r, k, v, logw, u, state, chunk=chunk)


def last_real(x: torch.Tensor, valid_len=None) -> torch.Tensor:
    """x[:, valid_len - 1] (x[:, -1] without ``valid_len``): an int, or a
    0-d device tensor read by a device index, never by the host."""
    if valid_len is None:
        return x[:, -1]
    if isinstance(valid_len, torch.Tensor):
        idx = (valid_len.reshape(1) - 1).to(device=x.device, dtype=torch.long)
        return x.index_select(1, idx)[:, 0]
    return x[:, valid_len - 1]


def rwkv_step(r, k, v, logw, u, state):
    """Single-token recurrence (decode).  r/k/v/logw: (B, H, K)."""
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    w = torch.exp(logw.to(torch.float32))              # (B, H, K)
    kv = kf[..., :, None] * vf[..., None, :]           # (B, H, K, V)
    u32 = u.to(torch.float32)[None, :, :, None]        # (1, H, K, 1)
    o = torch.einsum("bhk,bhkv->bhv", rf, state + u32 * kv)
    state = state * w[..., None] + kv
    return o, state


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  chunk: int = 0, prefix: str = "", valid_len=None):
    """Full RWKV6 time-mixing block.  state = (x_prev (B, d), S (B, H, K, K)).
    Returns (out, (x_last, S')).

    ``valid_len`` (an int or a 0-d device tensor) marks a right-padded
    prefill whose first ``valid_len`` rows are real: k and log w are zeroed
    on the pad rows, so their kv products never reach the state and their
    decay exp(0) = 1 keeps the cumsum past the last real token; the real
    rows keep their bits, since the pads sit after them."""
    chunk = chunk or cfg.rwkv_chunk
    B, S, d = x.shape
    H = cfg.n_heads
    K = d // H
    if state is None:
        x_prev = x.new_zeros((B, d))
        S0 = torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device)
    else:
        x_prev, S0 = state
    r, k, v, g, logw = _rwkv_inputs(p, x, x_prev, cfg, prefix)
    rh, kh, vh, lwh = (_heads(t, H) for t in (r, k, v, logw))
    if valid_len is not None:
        real = (torch.arange(S, device=x.device) < valid_len)[None, :, None, None]
        kh = torch.where(real, kh, torch.zeros((), dtype=kh.dtype, device=x.device))
        lwh = torch.where(real, lwh, torch.zeros((), dtype=lwh.dtype, device=x.device))
    if S == 1:
        o, S1 = rwkv_step(rh[:, 0], kh[:, 0], vh[:, 0], lwh[:, 0], p["u"], S0)
        o = o[:, None]
    else:
        o, S1 = rwkv_chunked(rh, kh, vh, lwh, p["u"], S0, chunk)
    o = o.reshape(B, S, d).to(x.dtype)
    # group-norm over heads (ln_x), then gate and output projection
    o32 = o.to(torch.float32).reshape(B, S, H, K)
    mean = o32.mean(-1, keepdim=True)
    var = o32.var(-1, keepdim=True, correction=0)
    o = ((o32 - mean) * torch.rsqrt(var + 1e-5)).reshape(B, S, d)
    o = (o * p["ln_x"].to(torch.float32)).to(x.dtype)
    out = apply_linear(p["wo"], o * g, cfg.ep(d, d, _nm(prefix, "wo")))
    return out, (last_real(x, valid_len), S1)


def init_rwkv_state(cfg: ModelConfig, batch: int, device="cuda"):
    """(x_prev (batch, d) in the compute dtype, S (batch, H, K, K) float32)."""
    d, H = cfg.d_model, cfg.n_heads
    K = d // H
    return (torch.zeros((batch, d), dtype=cfg.cdtype, device=device),
            torch.zeros((batch, H, K, K), dtype=torch.float32, device=device))


# -- RWKV channel mixing (the FFN of rwkv blocks) ----------------------------
def init_rwkv_ffn(generator: torch.Generator, cfg: ModelConfig, prefix: str = "",
                  device="cuda") -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype
    lin = lambda w, M, N: init_linear(generator, M, N, cfg.ep(M, N, _nm(prefix, w)),
                                      dtype=dt, device=device)
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dt, device=device),
        "wk": lin("wk", d, ff),
        "wv": lin("wv", ff, d),
        "wr": lin("wr", d, d),
    }


def rwkv_channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     x_prev: Optional[torch.Tensor] = None, prefix: str = "",
                     valid_len=None):
    """Pointwise over (shifted) positions, so a right-padded prefill
    (``valid_len``) only carries x at the last real token.  Returns (out,
    x_last)."""
    B, S, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros((B, d))
    xx = _shifted(x, x_prev)
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    k = apply_linear(p["wk"], xk, cfg.ep(d, cfg.d_ff, _nm(prefix, "wk")))
    k = torch.square(torch.relu(k))
    kv = apply_linear(p["wv"], k, cfg.ep(cfg.d_ff, d, _nm(prefix, "wv")))
    r = torch.sigmoid(apply_linear(p["wr"], xr, cfg.ep(d, d, _nm(prefix, "wr"))))
    return r * kv, last_real(x, valid_len)


# ===========================================================================
# Mamba (jamba's SSM layer)
# ===========================================================================
def init_mamba(generator: torch.Generator, cfg: ModelConfig, prefix: str = "",
               device="cuda") -> dict:
    d = cfg.d_model
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = max(1, d // 16)
    dtp = cfg.pdtype
    lin = lambda w, M, N, bias=False: init_linear(
        generator, M, N, cfg.ep(M, N, _nm(prefix, w)), bias=bias, dtype=dtp, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": lin("in_proj", d, 2 * di),
        "conv_w": (_randn(generator, dc, di) / math.sqrt(dc)).to(device=device, dtype=dtp),
        "conv_b": torch.zeros((di,), dtype=dtp, device=device),
        "x_proj": lin("x_proj", di, dt_rank + 2 * ds),
        "dt_proj": lin("dt_proj", dt_rank, di, bias=True),
        "A_log": torch.log(torch.arange(1, ds + 1, **f32)).repeat(di, 1),
        "D": torch.ones((di,), **f32),
        "out_proj": lin("out_proj", di, d),
    }


def _conv_window(xpad: torch.Tensor, valid_len, n: int) -> torch.Tensor:
    """The n rows of ``xpad`` that end at the last real token,
    xpad[:, valid_len : valid_len + n] (the trailing n rows without
    ``valid_len``): an int, or a 0-d device tensor read by a device index,
    never by the host."""
    if valid_len is None:
        return xpad[:, -n:]
    if isinstance(valid_len, torch.Tensor):
        idx = valid_len.reshape(1).to(device=xpad.device, dtype=torch.long) \
            + torch.arange(n, device=xpad.device)
        return xpad.index_select(1, idx)
    return xpad[:, valid_len:valid_len + n]


def mamba_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
              state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              chunk: int = 0, prefix: str = "", valid_len=None):
    """Mamba block.  state = (conv window (B, dc-1, di) in x's dtype, h (B,
    di, ds) float32), or None for zeros.  Returns (out, (conv window, h')).

    ``valid_len`` (an int or a 0-d device tensor) marks a right-padded
    prefill whose first ``valid_len`` rows are real: dt is 0 on the pad
    rows, so their scan steps are the exact identity (exp(0) = 1, dBx = 0),
    and the carried conv window ends at the last real token.  ``chunk`` is
    the plain scan's checkpoint window (cfg.mamba_chunk by default)."""
    chunk = chunk or cfg.mamba_chunk
    B, S, d = x.shape
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = max(1, d // 16)
    ep = lambda w, M, N: cfg.ep(M, N, _nm(prefix, w))
    xi, z = apply_linear(p["in_proj"], x, ep("in_proj", d, 2 * di)).chunk(2, dim=-1)
    if state is None:
        conv_buf, h0 = xi.new_zeros((B, dc - 1, di)), None
    else:
        conv_buf, h0 = state
    # the causal depthwise conv along S, its terms added in the reference's order
    xpad = torch.cat([conv_buf.to(xi.dtype), xi], dim=1)
    cw = p["conv_w"].to(xi.dtype)
    xc = xpad[:, :S] * cw[0]
    for i in range(1, dc):
        xc = xc + xpad[:, i:i + S] * cw[i]
    xc = F.silu(xc + p["conv_b"].to(xi.dtype))
    new_conv = _conv_window(xpad, valid_len, dc - 1) if dc > 1 else conv_buf
    # the input-dependent SSM parameters
    proj = apply_linear(p["x_proj"], xc, ep("x_proj", di, dt_rank + 2 * ds))
    dt, Bp, Cp = proj.split([dt_rank, ds, ds], dim=-1)
    dt = F.softplus(apply_linear(p["dt_proj"], dt, ep("dt_proj", dt_rank, di)))
    if valid_len is not None:
        real = (torch.arange(S, device=x.device) < valid_len)[None, :, None]
        dt = torch.where(real, dt, torch.zeros((), dtype=dt.dtype, device=x.device))
    A = -torch.exp(p["A_log"].to(torch.float32))
    y, h_last = ops.mamba_scan(dt, xc, Bp, Cp, A, p["D"], h0, chunk=chunk)
    y = y.to(x.dtype) * F.silu(z)
    out = apply_linear(p["out_proj"], y, ep("out_proj", di, d))
    return out, (new_conv, h_last)


def init_mamba_state(cfg: ModelConfig, batch: int, device="cuda"):
    """(conv window (batch, dc-1, di) in the compute dtype, h (batch, di,
    ds) float32)."""
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return (torch.zeros((batch, dc - 1, di), dtype=cfg.cdtype, device=device),
            torch.zeros((batch, di, ds), dtype=torch.float32, device=device))
