"""Plain PyTorch versions of the kernels, shape for shape the oracles of
``repro.kernels.ref`` (and, for the WKV, the chunked arithmetic of
``repro.models.ssm.rwkv_chunked``).  The kernel wrappers run these for
tensors on the CPU; on the card they are what each kernel is held
against."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.quant import dequantize_packed


def _col_block_list(col_blocks) -> list:
    return [int(c) for c in torch.as_tensor(col_blocks).tolist()]


def epitome_matmul_blocks_ref(x_folded: torch.Tensor, E: torch.Tensor,
                              col_blocks, bn: int) -> torch.Tensor:
    """y block j = x_folded @ E[:, cb[j]*bn : (cb[j]+1)*bn]."""
    cols = [x_folded @ E[:, cb * bn:(cb + 1) * bn]
            for cb in _col_block_list(col_blocks)]
    return torch.cat(cols, dim=-1).to(x_folded.dtype)


def quant_epitome_matmul_blocks_ref(x_folded: torch.Tensor, q: torch.Tensor,
                                    scales: torch.Tensor, zeros: torch.Tensor,
                                    col_blocks, bk: int, bn: int) -> torch.Tensor:
    """Dequantize the whole int8 epitome per (bk x bn) block, then the same
    column-block-indirected matmul as the fp version."""
    E = dequantize_packed(q, scales, zeros, (bk, bn))
    return epitome_matmul_blocks_ref(x_folded.to(torch.float32), E,
                                     col_blocks, bn).to(x_folded.dtype)


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
