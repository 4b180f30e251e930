"""Shared CPU models of the arithmetic of the tensor-core kernels (csrc/epitome_mma.cuh,
csrc/epitome_fp_mma.cuh and csrc/wkv6.cu), modelled in plain torch on the CPU.

The int8 kernels take (s, z) out of the product: per pack block b and output
block j, y += s * (x_b . q_b + z * sum_k x_k), with x_b . q_b on bf16 tensor
cores.  The model runs the same factored sum with the activation as one
bf16, as hi + lo (two bf16), as hi = bf16(x) and lo = fp16((x - hi) 2^8)
(what the float32 entries run) and, for a bf16 activation, exactly; it is
held against ``ref.quant_epitome_matmul_blocks_ref`` at the reference's
tolerances, and the float32 entries' split against the float64 sum.  Kernel
#5 is the same loop with no column table: its prefill sum (hi/lo, one flush
per 256-row crossbar tile) and its decode sum (a thread's 8 rows, 16 lanes
and the splits, each pairwise) are held against float64 at rwkv6-7b's
longest contraction.  Kernel #3's float32 entry is 3xTF32 (each operand as
two TF32 values, three products), held against its plain version at
ResNet-50's CR-4 shapes, where one TF32 pass misses the gate.  Kernel #2's
fold (each epitome row summing its virtual rows from the inverse table, in
ascending order) is held to ``ref.fold_blocks_ref`` bit for bit.  Kernel
#4, the chunked WKV (csrc/wkv6.cu), factors its decays by 16-token
sub-chunks and runs its four chunk products as 3xTF32 with a truncating
split; the model is held within the WKV gate of ``ref.wkv6_chunked_ref``
and of the JAX reference's ``ssm.rwkv_chunked``, where one TF32 pass
misses it.  Its gradient (csrc/wkv6_bwd.cu) runs the chunked backward on
the same arithmetic: the model holds dr, dk, dv, dlogw, du and dh0 within
the WKV gate of ``ref.wkv6_chunked_bwd_ref`` and of ``jax.grad`` of
``ssm.rwkv_chunked``, at log w = -20 too.  Mamba's scan (csrc/mamba_scan.cu)
takes 2^(dt A log2 e) on the SFU, A log2 e rounded once, and sums y by one
pairwise tree over the states whatever the lanes a channel is split over;
the model reads the kernel's log2(e) from its source, bounds the exponent
path against float64 and holds itself to ``ref.mamba_scan_ref`` at the fp32
gate.  Inputs are drawn with numpy from a seed; nothing here
needs a card.  The tests are ``tests/test_torch_mma_*.py``, a file a
kernel (and, where one would outlast a quarter of the suite's time, a
file a part of it)."""
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.epitome import EpitomeSpec
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops, ref

FP32 = 2e-4     # |y - ref| <= tol + tol |ref|, tests/test_kernels.py:17-18
BF16 = 2e-2

# rwkv6-7b kernel-q3's three projections (M, N, m, n, bm, bn), pack bk 256
LM_SPECS = [(4096, 4096, 1024, 4096, 256, 256), (4096, 14336, 1024, 14336, 256, 256),
            (14336, 4096, 3584, 4096, 256, 256)]
# three ResNet-50 CR-4 shapes, pack bk 16 (fc), 32 and 256
RESNET_SPECS = [(2048, 1000, 2000, 256, 256, 256), (1152, 128, 288, 128, 256, 128),
                (576, 64, 256, 64, 256, 64)]
CASES = ([(a, T) for a in LM_SPECS for T in (4, 64)]
         + [(a, 64) for a in RESNET_SPECS])


def _case(args, T, seed=0):
    rng = np.random.default_rng(seed)
    spec = EpitomeSpec(*args)
    E = torch.from_numpy((rng.standard_normal((spec.m, spec.n)) / np.sqrt(spec.M))
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((T, spec.m)).astype(np.float32))
    p = ops.pack_epitome(E, spec, QuantConfig(bits=3))
    return spec, x, p, torch.as_tensor(ops.kernel_col_blocks(spec, p.bn))


def mma_model(passes, q, scales, zeros, cb, bk, bn, dtype=torch.float32):
    """The kernels' sum: for each pack block b in order, the float32 running
    sum gains s * (P + z * R), P the products of the passes (bf16 or fp16
    values times integer codes, summed in float32) and R their row sums.
    With ``dtype=torch.float64`` and x itself as the one pass: the exact sum."""
    T, m = passes[0].shape
    nb = -(-m // bk)
    cb = [int(c) for c in cb]
    qf = F.pad(q.to(dtype), (0, 0, 0, nb * bk - m)).reshape(nb, bk, -1, bn)[:, :, cb]
    parts = [F.pad(p.to(dtype), (0, nb * bk - m)).reshape(T, nb, bk) for p in passes]
    y = torch.zeros(T, len(cb), bn, dtype=dtype)
    for b in range(nb):
        P = sum(torch.einsum("tk,kjc->tjc", part[:, b], qf[b]) for part in parts)
        R = sum(part[:, b].sum(-1) for part in parts)
        s, z = scales[b, cb].to(dtype), zeros[b, cb].to(dtype)
        y = y + s[None, :, None] * (P + z[None, :, None] * R[:, None, None])
    return y.reshape(T, -1)


def _hi_lo(x):
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()]


def _hi_fp16_lo(x):
    """The float32 entries' split: hi = bf16(x), lo = fp16((x - hi) 2^8)
    (clamped at 65504), here with the 2^8 taken back out, as the kernel's
    lo pass does with codes scaled by 2^-8."""
    hi = x.bfloat16().float()
    return [hi, ((x - hi) * 256).clamp(-65504, 65504).half().float() / 256]


def _over(y, r, tol):
    return bool(((y - r).abs() > tol + tol * r.abs()).any())


def table_fold(x, spec):
    """Kernel #2's fold: each epitome row starts at +0 and adds, in the
    table's ascending order, the virtual rows that sample it; a padded entry
    (M) reads the zero column."""
    table = torch.as_tensor(ops.fold_table(spec))          # (m, c)
    xp = F.pad(x, (0, 1))
    folded = torch.zeros(x.shape[0], spec.m)
    for c in range(table.shape[1]):
        folded = folded + xp[:, table[:, c]]
    return folded


# -- kernel #3: 3xTF32 -----------------------------------------------------------
# ResNet-50's 16 CR-4 kernel shapes (M, N, m, n, bm, bn)
RESNET_CR4 = [(576, 64, 256, 64, 256, 64), (1152, 128, 288, 128, 256, 128),
              (128, 512, 128, 256, 128, 256), (256, 512, 256, 256, 256, 256),
              (512, 128, 256, 128, 256, 128), (512, 256, 256, 256, 256, 256),
              (2304, 256, 576, 256, 256, 256), (256, 1024, 256, 256, 256, 256),
              (512, 1024, 512, 256, 256, 256), (1024, 256, 256, 256, 256, 256),
              (1024, 512, 512, 256, 256, 256), (4608, 512, 2304, 256, 256, 256),
              (512, 2048, 256, 2048, 256, 256), (1024, 2048, 256, 2048, 256, 256),
              (2048, 512, 1024, 256, 256, 256), (2048, 1000, 2000, 256, 256, 256)]


def tf32(v):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, ties away
    from zero (the magnitude's bit 12 carries), the low 13 bits 0."""
    return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _f32(t):
    return t.float().double()


def tf32_model(x, E, cb, bn, passes=3):
    """Kernel #3's float32 sum: per k8 step, x_lo E_hi, x_hi E_lo and
    x_hi E_hi (or, with passes=1, x_hi E_hi alone), each mma adding its 8
    exact products into one float32 accumulator."""
    cols = torch.cat([torch.arange(c * bn, (c + 1) * bn) for c in cb.tolist()])
    W = E[:, cols]
    xh, Wh = tf32(x), tf32(W)
    xl, Wl = tf32(x - xh), tf32(W - Wh)
    terms = [(xh, Wh)] if passes == 1 else [(xl, Wh), (xh, Wl), (xh, Wh)]
    acc = torch.zeros(x.shape[0], W.shape[1], dtype=torch.float64)
    for k in range(0, x.shape[1], 8):
        for a, b in terms:
            acc = _f32(acc + a[:, k:k + 8].double() @ b[k:k + 8].double())
    return acc.float()


def _fp_case(args, T=64):
    spec = EpitomeSpec(*args)
    rng = np.random.default_rng(0)
    E = torch.from_numpy((rng.standard_normal((spec.m, spec.n)) / np.sqrt(spec.M))
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((T, spec.M)).astype(np.float32))
    return spec, E, ops.fold_rows(x, spec), torch.as_tensor(ops.kernel_col_blocks(spec, spec.bn))


# -- kernel #5: kernel #1's loop with no column table -----------------------------
def _qm_case(M, N, T, seed=0):
    """Codes at the reference test's scales (tests/test_kernels.py:101-104):
    int8 over the whole range, one (s, z) per 256 x 256 tile."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-127, 128, (M, N)).astype(np.int8))
    s = torch.from_numpy((rng.random((M // 256, N // 256)) * 9e-3 + 1e-3).astype(np.float32))
    z = torch.from_numpy(np.round(rng.random((M // 256, N // 256)) * 6 - 3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((T, M)).astype(np.float32))
    W64 = (q.double() + z.double().repeat_interleave(256, 0).repeat_interleave(256, 1)) \
        * s.double().repeat_interleave(256, 0).repeat_interleave(256, 1)
    return x, q, s, z, x.double() @ W64


def _tree(v, dim):
    """Kernel #5's pairwise sum of 16 along ``dim`` (tree16): v[u] + v[u + 8],
    then + 4, + 2, + 1, each rounded to float32."""
    while v.shape[dim] > 1:
        h = v.shape[dim] // 2
        v = _f32(v.narrow(dim, 0, h) + v.narrow(dim, h, h))
    return v.squeeze(dim)


def decode_model(x, q, s, z, rows=128, pairwise=True):
    """The decode loop's sum for one 256 x 256 crossbar tile per (s, z): each
    thread FMAs its rows // 16 rows (codes times x) and sums x beside them,
    scales s (z sum x + p) once; the block's 16 row lanes, then the splits
    16 at a time (groups in split order) are summed pairwise, or each in
    order with ``pairwise=False``."""
    T, M = x.shape
    N = q.shape[1]
    R, splits = rows // 16, M // rows
    xs = x.double().reshape(T, splits, 16, R)
    qs = q.double().reshape(splits, 16, R, N)
    p = torch.zeros(T, splits, 16, N, dtype=torch.float64)
    rs = torch.zeros(T, splits, 16, 1, dtype=torch.float64)
    for r in range(R):
        p = _f32(p + xs[..., r, None] * qs[None, :, :, r])
        rs = _f32(rs + xs[..., r, None])
    blk = torch.arange(splits) * rows // 256
    sf = s.double()[blk].repeat_interleave(256, 1)[None, :, None]
    zf = z.double()[blk].repeat_interleave(256, 1)[None, :, None]
    v = _f32(sf * _f32(zf * rs + p))                     # (T, splits, 16, N)
    if pairwise:
        part = _tree(v, 2)
        y = torch.zeros(T, N, dtype=torch.float64)
        for g in range(0, splits, 16):
            grp = part[:, g:g + 16]
            grp = torch.cat([grp, grp.new_zeros(T, 16 - grp.shape[1], N)], 1)
            y = _f32(y + _tree(grp, 1))
        return y
    part = torch.zeros(T, splits, N, dtype=torch.float64)
    for l in range(16):
        part = _f32(part + v[:, :, l])
    y = torch.zeros(T, N, dtype=torch.float64)
    for k in range(splits):
        y = _f32(y + part[:, k])
    return y


def _gate(y, y64):
    """The reference tolerance against float64: |y - y64| <= 2e-4 + 2e-4 |y64|."""
    return bool(((y.double() - y64).abs() <= FP32 + FP32 * y64.abs()).all())


# -- kernel #4: the chunked WKV on TF32 tensor cores ------------------------------
WKV = 1e-3      # |y - ref| <= tol + tol |ref|, tests/test_kernels.py:85
# the reference's own cases (tests/test_kernels.py:67-72, ragged S = 50
# included), and rwkv6-7b's head (K = 64, chunk 64) over four chunks
WKV_CASES = [(1, 16, 1, 8, 8), (2, 64, 2, 16, 16), (2, 50, 2, 8, 16), (1, 128, 4, 32, 64),
             (1, 256, 2, 64, 64)]


def tf32_trunc(v):
    """Kernel #4's split: float32 with its low 13 bits cleared (a bitwise
    and, where kernel #3's cvt.rna rounds, ``tf32``)."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mma(acc, a, b, passes):
    """acc (.., M, N) + a (.., M, k) @ b (.., k, N) as the kernel's mma.sync
    k8 steps: each operand split into hi = tf32(x), lo = tf32(x - hi); per
    step lo hi, hi lo, hi hi (or hi hi alone, passes=1), each adding its 8
    exact products into the float32 accumulator.  A bf16 operand's lo is 0,
    its pass adds nothing, as the kernel skips it."""
    ah, bh = tf32_trunc(a), tf32_trunc(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
    for k in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = _f32(acc + x[..., k:k + 8].double() @ y[..., k:k + 8, :].double())
    return acc


def wkv6_mma_model(r, k, v, logw, u, h0=None, chunk=64, passes=3):
    """Kernel #4's arithmetic: per chunk, a tile of 16 x ceil(L / 16) tokens
    (rows past L zero, logw 0), cs and cs_prev = cs - logw in float32; the
    inter-chunk product (r exp(cs_prev)) @ S; the scores of sub-chunk b
    against earlier ones through c = cs just before b, (r exp(min(cs_prev -
    c, 0))) @ (k exp(c - cs))^T; tokens 8..15 of b against 0..7 through cs
    at token 7; the two 8 x 8 diagonal blocks with exact exponents clamped
    at 0; scores @ v into the same accumulator, the u bonus, and the state
    S exp(cs_L) + (k exp(cs_L - cs))^T @ v.  (B, S, H, K) in, (o, hT) out,
    float32.  The exponentials are torch's; the kernel's __expf is within
    3e-6 of them, far inside the gate."""
    B, S, H, K = r.shape
    L = max(1, min(chunk, S))
    n, T, KP = -(-S // L), 16 * -(-L // 16), 8 * -(-K // 8)

    def tiles(t):      # (B, H, n, T, KP)
        t = F.pad(t.float().permute(0, 2, 1, 3), (0, KP - K, 0, n * L - S))
        return F.pad(t.reshape(B, H, n, L, KP), (0, 0, 0, T - L))

    rf, kf, vf, wf = tiles(r), tiles(k), tiles(v), tiles(logw)
    uf = F.pad(u.float(), (0, KP - K))[None, :, None, :]
    St = torch.zeros(B, H, KP, KP, dtype=torch.float64)
    if h0 is not None:
        St[..., :K, :K] = h0.double()
    tri = torch.ones(8, 8, dtype=torch.bool).tril(-1)
    outs = []
    for c in range(n):
        rc, kc, vc, wc = rf[:, :, c], kf[:, :, c], vf[:, :, c], wf[:, :, c]
        cs = wc.cumsum(2)
        cp = cs - wc
        o = _mma(torch.zeros(B, H, T, KP, dtype=torch.float64), rc * cp.exp(), St.float(),
                 passes)
        sc = torch.zeros(B, H, T, T, dtype=torch.float64)
        for R0 in range(0, T, 16):
            rows = slice(R0, R0 + 16)
            if R0:
                cw = cs[:, :, R0 - 1:R0]
                A = rc[:, :, rows] * (cp[:, :, rows] - cw).clamp_max(0).exp()
                Bt = (kc[:, :, :R0] * (cw - cs[:, :, :R0]).exp()).transpose(-1, -2)
                sc[:, :, rows, :R0] = _mma(sc[:, :, rows, :R0], A, Bt, passes)
            lo, hi = slice(R0, R0 + 8), slice(R0 + 8, R0 + 16)
            cq = cs[:, :, R0 + 7:R0 + 8]
            A = rc[:, :, hi] * (cp[:, :, hi] - cq).clamp_max(0).exp()
            Bt = (kc[:, :, lo] * (cq - cs[:, :, lo]).exp()).transpose(-1, -2)
            sc[:, :, hi, lo] = _mma(sc[:, :, hi, lo], A, Bt, passes)
            for blk in (lo, hi):
                e = (cp[:, :, blk, None] - cs[:, :, None, blk]).clamp_max(0).exp()
                full = (rc[:, :, blk, None] * e * kc[:, :, None, blk]).double().sum(-1)
                sc[:, :, blk, blk] = _f32(full * tri)
        o = _mma(o, sc.float(), vc, passes)
        bonus = _f32(((rc * uf) * kc).double().sum(-1, keepdim=True))
        outs.append(_f32(o + bonus * vc.double())[:, :, :L])
        csL = cs[:, :, -1:]
        St = _mma(_f32(St * csL.transpose(-1, -2).exp().double()),
                  (kc * (csL - cs).exp()).transpose(-1, -2), vc, passes)
    o = torch.cat(outs, 2)[:, :, :S, :K].permute(0, 2, 1, 3)
    return o.float(), St[..., :K, :K].float()


def _wkv_case(B, S, H, K, bf16=False, logw=None, seed=0):
    """Inputs with numpy from a seed, and a state; r, k, v rounded to bf16
    (exact in TF32) for the LM's case."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    r, k, v = f(B, S, H, K), f(B, S, H, K), f(B, S, H, K)
    lw = -torch.exp(f(B, S, H, K) * 0.5) if logw is None else torch.full((B, S, H, K), logw)
    u, h0 = f(H, K) * 0.1, f(B, H, K, K) * 0.5
    if bf16:
        r, k, v = (t.bfloat16().float() for t in (r, k, v))
    return r, k, v, lw, u, h0


def _within(y, ref, tol=WKV):
    return bool(torch.isfinite(y).all()) and not _over(y, ref, tol)


# -- kernel #4's gradient: the chunked WKV backward (csrc/wkv6_bwd.cu) -----------
def _scan(x, dim, reverse=False):
    """Sequential float32 sums along ``dim`` as the kernel's threads take
    them, one token after the other: (inclusive sums, total)."""
    idx = range(x.shape[dim] - 1, -1, -1) if reverse else range(x.shape[dim])
    acc, out = torch.zeros_like(x.select(dim, 0)), torch.empty_like(x)
    for t in idx:
        acc = _f32(acc + x.select(dim, t))
        out.select(dim, t).copy_(acc)
    return out, acc


def wkv6_bwd_mma_model(r, k, v, logw, u, h0, do, dhT=None, passes=3):
    """The backward kernel's arithmetic.  Chunks of 64 tokens (rows past S
    zero, logw 0); cs in float32 in time order and cp_t = cs_{t-1}.  (The
    kernel sums the cumsum, dlogw's scan, C and du in parts of 8 tokens or
    columns and takes some decays as products of two tabled factors; the
    model sums in order and takes one exponential, within 1e-6 of it.)  Sweep
    1 stores each chunk's start state S0, updated as kernel #4 updates it.
    Sweep 2 walks the chunks backward carrying dS (the gradient of the
    chunk's end state) and per 16-token block R0:
      scores A  (r e^{min(cp - c, 0)}) @ (k e^{c - cs})^T against earlier
                blocks, c = cs_{R0-1}; inside the block, tokens 8..15 against
                0..7 through cs at token 7, the 8 x 8 diagonal blocks exactly;
      dA        do @ v^T, strictly causal;
      dv        A^T @ do + (k e^{csL - cs}) @ dS, + bonus do;
      dr        e^{cp - c} (do @ (e^c S0)^T + dA_{<R0} @ (k e^{c - cs})),
                + the block's own pairs (as the scores), + u k (do.v);
      dk        e^{c' - cs} (dA^T_{>R0+15} @ (r e^{cp - c'}) + v @ (e^{csL - c'} dS)^T),
                c' = cs_{R0+15}, + the block's own pairs, + r u (do.v);
      dS0       e^{csL} dS + (r e^{cp})^T @ do;
      dlogw_s   C + sum_{t>s} r_t dr_t - sum_{t>=s} k_t dk_t (the bonus
                terms left out), C = rowsum(dS * S_L), S_L the chunk's end
                state, as one float32 scan from the last token;
      du       += sum_t r k (do.v).
    Products as 3xTF32 k8 steps (``_mma``).  Returns (dr, dk, dv, dlogw,
    du, dh0), float32."""
    B, S, H, K = r.shape
    T, n, KP = 64, max(1, -(-S // 64)), 8 * -(-K // 8)

    def tiles(t):      # (B, H, n, T, KP)
        t = F.pad(t.float().permute(0, 2, 1, 3), (0, KP - K, 0, n * T - S))
        return t.reshape(B, H, n, T, KP)

    rf, kf, vf, wf, df = tiles(r), tiles(k), tiles(v), tiles(logw), tiles(do)
    uf = F.pad(u.float(), (0, KP - K))[None, :, None, :]
    mm = lambda acc, a, b: _mma(acc, a, b, passes)
    z = lambda *s: torch.zeros(B, H, *s, dtype=torch.float64)
    St = z(KP, KP)
    if h0 is not None:
        St[..., :K, :K] = h0.double()
    cums = []
    starts = []
    for c in range(n):
        cs, _ = _scan(wf[:, :, c].double(), 2)
        cs = cs.float()
        cums.append(cs)
        starts.append(St)
        csL = cs[:, :, -1:]
        St = mm(_f32(St * csL.transpose(-1, -2).exp().double()),
                (kf[:, :, c] * (csL - cs).exp()).transpose(-1, -2), vf[:, :, c])
    dS = z(KP, KP)
    if dhT is not None:
        dS[..., :K, :K] = dhT.double()
    C = _scan(dS * St, 3)[1]                         # (B, H, KP): rowsum(dS_T * S_T)
    du = z(KP)
    outs = {name: [None] * n for name in ("dr", "dk", "dv", "dlw")}
    tri = torch.ones(T, T, dtype=torch.bool).tril(-1)
    for c in reversed(range(n)):
        rc, kc, vc, dc, cs = rf[:, :, c], kf[:, :, c], vf[:, :, c], df[:, :, c], cums[c]
        S0 = starts[c]
        cp = F.pad(cs, (0, 0, 1, 0))[:, :, :T]       # cs_{t-1}, 0 at t = 0
        csL = cs[:, :, -1:]
        dov = _scan((dc * vc).double(), 3)[1][..., None]
        bn = _scan((rc * uf * kc).double(), 3)[1][..., None]
        A = z(T, T)
        for R0 in range(0, T, 16):
            rows = slice(R0, R0 + 16)
            if R0:
                cw = cs[:, :, R0 - 1:R0]
                A[:, :, rows, :R0] = mm(A[:, :, rows, :R0],
                                        rc[:, :, rows] * (cp[:, :, rows] - cw).clamp_max(0).exp(),
                                        (kc[:, :, :R0] * (cw - cs[:, :, :R0]).exp()).transpose(-1, -2))
            lo, hi = slice(R0, R0 + 8), slice(R0 + 8, R0 + 16)
            cq = cs[:, :, R0 + 7:R0 + 8]
            A[:, :, hi, lo] = mm(A[:, :, hi, lo],
                                 rc[:, :, hi] * (cp[:, :, hi] - cq).clamp_max(0).exp(),
                                 (kc[:, :, lo] * (cq - cs[:, :, lo]).exp()).transpose(-1, -2))
            for d in (lo, hi):
                e = (cp[:, :, d, None] - cs[:, :, None, d]).clamp_max(0).exp()
                full = (rc[:, :, d, None] * e * kc[:, :, None, d]).double().sum(-1)
                A[:, :, d, d] = _f32(full * tri[:8, :8])
        dA = mm(z(T, T), dc, vc.transpose(-1, -2)) * tri
        dAf = dA.float()
        dr, dk, dv, P, Q = (z(T, KP) for _ in range(5))
        kdec = kc * (csL - cs).exp()
        for R0 in range(0, T, 16):
            rows = slice(R0, R0 + 16)
            # dv: A^T do over t >= R0, then (k e^{csL - cs}) dS, then the bonus
            acc = mm(z(16, KP), A[:, :, R0:, rows].transpose(-1, -2).float(), dc[:, :, R0:])
            acc = mm(acc, kdec[:, :, rows], dS.float())
            dv[:, :, rows] = _f32(acc + (bn[:, :, rows] * dc[:, :, rows]).double())
            # the block's own pairs: tokens 8..15 against 0..7 through cs at
            # token 7, the two 8 x 8 diagonal blocks exactly,
            # w[t, i, k] = dA_ti exp(min(cp_t - cs_i, 0))
            lo, hi = slice(R0, R0 + 8), slice(R0 + 8, R0 + 16)
            c7 = cs[:, :, R0 + 7:R0 + 8]
            own_r, own_k = z(16, KP), z(16, KP)
            own_r[:, :, 8:] = _f32(mm(z(8, KP), dAf[:, :, hi, lo],
                                      kc[:, :, lo] * (c7 - cs[:, :, lo]).exp())
                                   * (cp[:, :, hi] - c7).clamp_max(0).exp().double())
            own_k[:, :, :8] = _f32(mm(z(8, KP), dAf[:, :, hi, lo].transpose(-1, -2),
                                      rc[:, :, hi] * (cp[:, :, hi] - c7).clamp_max(0).exp())
                                   * (c7 - cs[:, :, lo]).exp().double())
            for q, d in ((slice(0, 8), lo), (slice(8, 16), hi)):
                e = (cp[:, :, d, None] - cs[:, :, None, d]).clamp_max(0).exp()
                w = dAf[:, :, d, d, None] * e
                own_r[:, :, q] = _f32(own_r[:, :, q] + (w * kc[:, :, None, d]).double().sum(3))
                own_k[:, :, q] = _f32(own_k[:, :, q] + (w * rc[:, :, d, None]).double().sum(2))
            # dr: through c = cs_{R0-1}
            cw = cp[:, :, R0:R0 + 1]
            acc = mm(z(16, KP), dc[:, :, rows],
                     (S0.float() * cw.transpose(-1, -2).exp()).transpose(-1, -2))
            if R0:
                acc = mm(acc, dAf[:, :, rows, :R0], kc[:, :, :R0] * (cw - cs[:, :, :R0]).exp())
            nb = _f32(_f32(acc * (cp[:, :, rows] - cw).clamp_max(0).exp().double()) + own_r)
            P[:, :, rows] = _f32(rc[:, :, rows].double() * nb)
            dr[:, :, rows] = _f32(nb + (uf * kc[:, :, rows]).double() * dov[:, :, rows])
            # dk: through c' = cs_{R0+15}
            cq = cs[:, :, R0 + 15:R0 + 16]
            acc = z(16, KP)
            if R0 + 16 < T:
                acc = mm(acc, dAf[:, :, R0 + 16:, rows].transpose(-1, -2),
                         rc[:, :, R0 + 16:] * (cp[:, :, R0 + 16:] - cq).clamp_max(0).exp())
            acc = mm(acc, vc[:, :, rows],
                     (dS.float() * (csL - cq).transpose(-1, -2).exp()).transpose(-1, -2))
            nb = _f32(_f32(acc * (cq - cs[:, :, rows]).exp().double()) + own_k)
            Q[:, :, rows] = _f32(kc[:, :, rows].double() * nb)
            dk[:, :, rows] = _f32(nb + (rc[:, :, rows] * uf).double() * dov[:, :, rows])
        # dS0 = e^{csL} dS + (r e^{cp})^T do
        dS0 = mm(_f32(dS * csL.transpose(-1, -2).exp().double()),
                 (rc * cp.exp()).transpose(-1, -2), dc)
        # dlogw_s = C - sum_{t>=s} Q_t + sum_{t>s} P_t, one scan from the last token
        acc, dlw = C, z(T, KP)
        for s in reversed(range(T)):
            acc = _f32(acc - Q[:, :, s])
            dlw[:, :, s] = acc
            acc = _f32(acc + P[:, :, s])
        for t in reversed(range(T)):
            du = _f32(du + _f32((rc[:, :, t] * kc[:, :, t]).double()) * dov[:, :, t])
        C = _scan(dS0 * S0, 3)[1]
        dS = dS0
        for name, t in (("dr", dr), ("dk", dk), ("dv", dv), ("dlw", dlw)):
            outs[name][c] = t

    def untile(ts):
        t = torch.stack(ts, 2).reshape(B, H, n * T, KP)[:, :, :S, :K]
        return t.permute(0, 2, 1, 3).float()

    du = _scan(du[..., :K], 0)[1].float()            # du_reduce: batch order
    return (untile(outs["dr"]), untile(outs["dk"]), untile(outs["dv"]), untile(outs["dlw"]),
            du, dS[..., :K, :K].float())


def _wkv_bwd_case(B, S, H, K, bf16=False, state=True, logw=None, seed=0):
    """_wkv_case's inputs and the gradients of o and of the final state;
    without ``state`` a zero h0 and no dhT (None)."""
    r, k, v, lw, u, h0 = _wkv_case(B, S, H, K, bf16, logw=logw, seed=seed)
    rng = np.random.default_rng(seed + 7)
    do = torch.from_numpy(rng.standard_normal((B, S, H, K)).astype(np.float32))
    dhT = torch.from_numpy(rng.standard_normal((B, H, K, K)).astype(np.float32))
    return (r, k, v, lw, u) + ((h0, do, dhT) if state else (None, do, None))


def _jax_wkv_grads(r, k, v, lw, u, h0, do, dhT, chunk):
    """jax.grad of sum(o * do) + sum(hT * dhT) through the reference's
    ``ssm.rwkv_chunked`` (a zero h0 and dhT for None): (dr, dk, dv, dlogw,
    du, dh0)."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    B, S, H, K = r.shape
    zero = torch.zeros(B, H, K, K)
    s, dh = (zero if t is None else t for t in (h0, dhT))

    def f(r, k, v, lw, u, s):
        o, hT = jssm.rwkv_chunked(r, k, v, lw, u, s, chunk=chunk)
        return jnp.sum(o * jnp.asarray(do.numpy())) + jnp.sum(hT * jnp.asarray(dh.numpy()))
    grads = jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(t.numpy()) for t in (r, k, v, lw, u, s)))
    return [torch.from_numpy(np.array(g)) for g in grads]


# -- Mamba's selective scan (csrc/mamba_scan.cu) ---------------------------------
SCAN_SRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/mamba_scan.cu"
# log2(e) as the kernel rounds it to float32, read from its source
SCAN_LOG2E = float.fromhex(re.search(r"LOG2E = (0x[0-9a-f.]+p[+-]?\d+)f",
                                     SCAN_SRC.read_text()).group(1))
SCAN_STATES = 16        # states a channel keeps; those past ds are zero
# ex2.approx.ftz.f32's relative error (PTX ISA: 2 ulp over the full range)
SCAN_EX2_ERR = 2.0 ** -22


def _fma(a, b, c):
    """fma in float32, through float64: a b is exact there, and the sum is
    rounded twice (once to float64), which can differ from one rounding in
    the last bit on rare ties; the model is held to the plain version at the
    gate, not to the card's bits."""
    return (a.double() * b.double() + c.double()).float()


def scan_exp2(e):
    """ex2.approx.ftz.f32, stood in for by torch.exp2 with results below
    2^-126 flushed to zero."""
    r = torch.exp2(e)
    return torch.where(r < 2.0 ** -126, torch.zeros_like(r), r)


def _scan_tree(v):
    """Pairwise sum over the last axis (a power of two), in float32."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def mamba_scan_model(dt, x, Bm, Cm, A, D, h0=None, lanes=4):
    """The scan kernel's arithmetic in float32 torch, its channel's 16
    states on ``lanes`` lanes: A2 = A log2(e) rounded once; dA = 2^(dt A2)
    (the SFU stand-in); dBx = (dt x) B; h = fma(dA, h, dBx); each h C
    rounded on its own, summed pairwise inside a lane, then one exchange
    level for each doubling of the lanes (keep + the partner's); y = fma(D,
    x, sum).  States past ds are zero.  Returns (y, hT) as the plain version
    does."""
    Bsz, S, di = dt.shape
    ds = Bm.shape[-1]
    pad = lambda t: F.pad(t.float(), (0, SCAN_STATES - ds))
    dt, x, D = dt.float(), x.float(), D.float()
    Bm, Cm = pad(Bm), pad(Cm)
    A2 = pad(A) * SCAN_LOG2E
    h = torch.zeros(Bsz, di, SCAN_STATES) if h0 is None else pad(h0)
    npl = SCAN_STATES // lanes
    ys = []
    for t in range(S):
        dA = scan_exp2(dt[:, t, :, None] * A2)
        dBx = (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        h = _fma(dA, h, dBx)
        part = _scan_tree((h * Cm[:, t, None, :]).reshape(Bsz, di, lanes, npl))
        m = 1
        while m < lanes:
            part = part + part[..., torch.arange(lanes) ^ m]
            m *= 2
        ys.append(_fma(D, x[:, t], part[..., 0]))
    y = torch.stack(ys, 1) if ys else torch.zeros(Bsz, 0, di)
    return y, h[..., :ds].contiguous()


def _scan_case(B, S, di, ds, state=True, seed=0):
    """Inputs with numpy from a seed: dt = softplus(N - 1), A = -exp(N / 2)
    (the LM's), bf16-exact B and C."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    dt = F.softplus(f(B, S, di) - 1.0)
    A = -torch.exp(f(di, ds) * 0.5)
    return (dt, f(B, S, di), f(B, S, ds).bfloat16().float(), f(B, S, ds).bfloat16().float(),
            A, f(di), f(B, di, ds) if state else None)
