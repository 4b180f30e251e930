"""Plain PyTorch versions of the kernels, shape for shape the oracles of
``repro.kernels.ref`` (and, for the WKV, the chunked arithmetic of
``repro.models.ssm.rwkv_chunked``; for the Mamba scan, the recurrence of
``repro.models.ssm.mamba_mix``).  The kernel wrappers run these for
tensors on the CPU; on the card they are what each kernel is held
against."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.quant import dequantize_packed


def _col_block_list(col_blocks) -> list:
    return [int(c) for c in torch.as_tensor(col_blocks).tolist()]


def epitome_matmul_blocks_ref(x_folded: torch.Tensor, E: torch.Tensor,
                              col_blocks, bn: int) -> torch.Tensor:
    """y block j = x_folded @ E[:, cb[j]*bn : (cb[j]+1)*bn]."""
    cols = [x_folded @ E[:, cb * bn:(cb + 1) * bn]
            for cb in _col_block_list(col_blocks)]
    return torch.cat(cols, dim=-1).to(x_folded.dtype)


# rows a product of the plain kernel #1 takes at once: every call runs
# products of this one shape, so a row's bits do not depend on the row count
ROW_BLOCK = 64


def quant_epitome_matmul_blocks_ref(x_folded: torch.Tensor, q: torch.Tensor,
                                    scales: torch.Tensor, zeros: torch.Tensor,
                                    col_blocks, bk: int, bn: int) -> torch.Tensor:
    """Dequantize the whole int8 epitome per (bk x bn) block, then the same
    column-block-indirected matmul as the fp version, ROW_BLOCK rows at a
    time (the rows zero-padded to a multiple of it).  A float32 matmul's
    summation order follows its shape, and a library picks another order
    for another row count; products of one fixed shape sum every row alike,
    so a row's result is the same in a call of any length (a rank of a
    data-parallel split computes its rows as one card does)."""
    E = dequantize_packed(q, scales, zeros, (bk, bn))
    x = x_folded.to(torch.float32)
    T = x.shape[0]
    xp = F.pad(x, (0, 0, 0, -T % ROW_BLOCK))
    blocks = [epitome_matmul_blocks_ref(xp[i:i + ROW_BLOCK], E, col_blocks, bn)
              for i in range(0, xp.shape[0], ROW_BLOCK)]
    return torch.cat(blocks)[:T].to(x_folded.dtype)


def quant_matmul_ref(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                     zeros: torch.Tensor, tile: int = 256) -> torch.Tensor:
    """x @ ((q + z) * s) with per-(tile x tile) scale/zero; the sum in
    float32, the result in x's dtype."""
    M, N = q.shape
    s_full = scales.repeat_interleave(tile, 0).repeat_interleave(tile, 1)[:M, :N]
    z_full = zeros.repeat_interleave(tile, 0).repeat_interleave(tile, 1)[:M, :N]
    W = (q.to(torch.float32) + z_full) * s_full
    return (x.to(torch.float32) @ W).to(x.dtype)


def fold_blocks_ref(x: torch.Tensor, row_offsets, bm: int, m: int) -> torch.Tensor:
    """Fold the unfolded activation x (T, M) into epitome-row space (T, m):
    virtual row block i (rows [i*bm, (i+1)*bm), the last one possibly short)
    adds into epitome rows [ro[i], ro[i]+bm), in ascending i."""
    T, M = x.shape
    folded = x.new_zeros(T, m)
    for i, off in enumerate(_col_block_list(row_offsets)):
        lo, hi = i * bm, min(M, (i + 1) * bm)
        if lo < hi:
            folded[:, off:off + hi - lo] += x[:, lo:hi]
    return folded


def quant_epitome_matmul_fused_fold_ref(x: torch.Tensor, q: torch.Tensor,
                                        scales: torch.Tensor, zeros: torch.Tensor,
                                        col_blocks, row_offsets, *, bm: int,
                                        bk: int, bn: int) -> torch.Tensor:
    """The fused-fold kernel's function: the fold of ``fold_blocks_ref``
    followed by the quantized block matmul.  x is the unfolded (T, M)
    activation; q's rows may be zero-padded past the folded width."""
    folded = fold_blocks_ref(x.to(torch.float32), row_offsets, bm, q.shape[0])
    return quant_epitome_matmul_blocks_ref(folded, q, scales, zeros,
                                           col_blocks, bk, bn)


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor,
                     state: Optional[torch.Tensor] = None, *,
                     chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked WKV of ``ssm.rwkv_chunked``, op for op.  r/k/v/logw:
    (B, S, H, K), logw <= 0; u: (H, K); state: (B, H, K, K) or None (zero).
    Returns (o (B, S, H, K), final state), float32; the sequence is
    zero-padded to whole chunks of min(chunk, S)."""
    B, S, H, K = r.shape
    L = max(1, min(chunk, S))
    n = -(-S // L)

    def chunks(t):
        return F.pad(t.float(), (0, 0, 0, 0, 0, n * L - S)).reshape(B, n, L, H, K)

    rf, kf, vf, lw = chunks(r), chunks(k), chunks(v), chunks(logw)
    uf = u.float()
    S_c = (torch.zeros((B, H, K, K), device=r.device) if state is None
           else state.float())
    tri = torch.ones((L, L), dtype=torch.bool, device=r.device).tril(-1)
    outs = []
    for c in range(n):
        rc, kc, vc, lwc = rf[:, c], kf[:, c], vf[:, c], lw[:, c]    # (B,L,H,K)
        cs = lwc.cumsum(1)                                          # <= 0
        cs_prev = cs - lwc
        o = torch.einsum("blhk,bhkv->blhv", rc * cs_prev.exp(), S_c)
        expo = (cs_prev[:, :, None] - cs[:, None, :]).clamp_max(0.0)  # (B,t,i,H,K)
        scores = torch.einsum("bthk,btihk,bihk->bthi", rc, expo.exp(), kc)
        scores = scores * tri[None, :, None, :]
        o = o + torch.einsum("bthi,bihv->bthv", scores, vc)
        bonus = torch.einsum("blhk,blhk->blh", rc * uf, kc)
        o = o + bonus[..., None] * vc
        cs_L = cs[:, -1:]
        k_dec = kc * (cs_L - cs).exp()
        S_c = S_c * cs_L[:, 0].exp()[..., None] + torch.einsum("blhk,blhv->bhkv", k_dec, vc)
        outs.append(o)
    return torch.stack(outs, 1).reshape(B, n * L, H, K)[:, :S], S_c


def wkv6_naive_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The token-by-token recurrence of ``repro.kernels.ref.wkv6_ref`` in
    the model's (B, S, H, K) layout, with a state in and out:
    o_t = r_t (S + diag(u) k_t^T v_t), S <- diag(w_t) S + k_t^T v_t."""
    B, S, H, K = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = logw.float().exp()
    uf = u.float()[None, :, :, None]
    S_c = (torch.zeros((B, H, K, K), device=r.device) if state is None
           else state.float())
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]           # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S_c + uf * kv))
        S_c = S_c * w[:, t, :, :, None] + kv
    o = torch.stack(outs, 1) if outs else rf.new_zeros((B, 0, H, K))
    return o, S_c


def wkv6_chunked_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logw: torch.Tensor, u: torch.Tensor,
                         state: Optional[torch.Tensor], do: torch.Tensor,
                         dhT: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The gradient of the WKV recurrence, token by token, in float32: given
    ``do`` (B, S, H, K), the gradient of o, and ``dhT`` (B, H, K, K), that
    of the final state (None: zero), with w_t = exp(logw_t) and dS the
    gradient of the state after token t, backward in t:
        dr_t = S_{t-1} do_t + u k_t (do_t . v_t)
        dk_t = r_t u (do_t . v_t) + dS v_t
        dv_t = (sum_i r_t u k_t) do_t + dS^T k_t
        dlogw_t = w_t * rowsum(dS * S_{t-1})
        du += r_t k_t (do_t . v_t),   dS <- diag(w_t) dS + r_t^T do_t
    The states S_{t-1} come from a forward sweep from ``state`` (None:
    zero).  Returns (dr, dk, dv, dlogw, du, dh0), float32; dh0 is the
    gradient of the initial state."""
    B, S, H, K = r.shape
    rf, kf, vf, dof = r.float(), k.float(), v.float(), do.float()
    w = logw.float().exp()
    uf = u.float()
    S_c = (torch.zeros((B, H, K, K), device=r.device) if state is None
           else state.float())
    states = []
    for t in range(S):
        states.append(S_c)
        S_c = S_c * w[:, t, :, :, None] + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    dS = (torch.zeros((B, H, K, K), device=r.device) if dhT is None
          else dhT.float())
    dr, dk, dv, dlw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((H, K), device=r.device)
    for t in reversed(range(S)):
        rt, kt, vt, dot, wt = rf[:, t], kf[:, t], vf[:, t], dof[:, t], w[:, t]
        dov = (dot * vt).sum(-1)[..., None]                         # (B, H, 1)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", states[t], dot) + uf * kt * dov
        du = du + (rt * kt * dov).sum(0)
        dk[:, t] = rt * uf * dov + torch.einsum("bhij,bhj->bhi", dS, vt)
        bonus = (rt * uf * kt).sum(-1)[..., None]                   # (B, H, 1)
        dv[:, t] = bonus * dot + torch.einsum("bhij,bhi->bhj", dS, kt)
        dlw[:, t] = wt * (dS * states[t]).sum(-1)
        dS = dS * wt[..., None] + rt[..., :, None] * dot[..., None, :]
    return dr, dk, dv, dlw, du, dS


def _mamba_scan_tokens(h, dt, x, Bm, Cm, A, D):
    """The selective scan over the tokens of one window, one by one, all
    float32: (y (B, L, di), h after the last token)."""
    ys = []
    for t in range(dt.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A)                      # (B, di, ds)
        dBx = (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        h = dA * h + dBx
        ys.append((h * Cm[:, t, None, :]).sum(-1) + D * x[:, t])
    return torch.stack(ys, 1), h


def mamba_scan_ref(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   A: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                   chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba's selective scan, token by token in float32, per (batch,
    channel d, state n):
        dA = exp(dt_t A),  dBx = (dt_t x_t) B_t,  h = dA h + dBx,
        y_t = sum_n h[n] C_t[n] + D x_t.
    dt, x: (B, S, di); Bm, Cm: (B, S, ds); A (di, ds) and D (di) float32;
    h0 (B, di, ds) or None (zero).  Returns (y (B, S, di), hT (B, di, ds)),
    float32.  No (B, S, di, ds) tensor is built; where autograd records,
    each window of ``chunk`` tokens runs under one checkpoint, so its
    backward keeps one state a window (the reference's memory rule)."""
    Bsz, S, di = dt.shape
    ds = Bm.shape[-1]
    ins = (dt, x, Bm, Cm, A, D, h0)
    record = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ins)
    dt, x, Bm, Cm, A, D = (t.float() for t in ins[:6])
    h = (torch.zeros((Bsz, di, ds), device=dt.device) if h0 is None else h0.float())
    L = max(1, min(chunk, S))
    ys = []
    for lo in range(0, S, L):
        window = (h, dt[:, lo:lo + L], x[:, lo:lo + L], Bm[:, lo:lo + L], Cm[:, lo:lo + L],
                  A, D)
        if record:
            y, h = checkpoint(_mamba_scan_tokens, *window, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            y, h = _mamba_scan_tokens(*window)
        ys.append(y)
    return (torch.cat(ys, 1) if ys else dt.new_zeros((Bsz, 0, di))), h
