"""Epitome: the paper's compact neural operator (EPIM §2.2, Eq. 1, Fig. 1).

An epitome ``E`` is a small learnable (m, n) matrix; a sampler takes
(possibly overlapping) patches of ``E`` and concatenates them into the full
(M, N) weight ``W`` in crossbar space (rows = c_in*kh*kw word lines, cols =
c_out bit lines).  Patch offsets are static, so the IFAT/IFRT/OFAT tables of
the PIM datapath become numpy index maps fixed when a layer is built;
reconstruction is a gather, and the epitome-space matmul's fold, a sum of
each epitome row's preimages, is a gather and a sum too.

Counterpart of ``repro.core.epitome``: the spec, its offsets and index maps
are the same numpy code, so every integer table equals the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EpitomeSpec:
    """Static description of one epitomized weight matrix.

    W_virtual is (M, N); the epitome parameter is (m, n); the sampler tiles W
    with a grid of (gm x gn) patches of size (bm, bn), patch (i, j) sampled
    from E at (row_off[i], col_off[j]).  Offsets are evenly spread across the
    epitome so every cell of E is used and adjacent patches overlap whenever
    m < gm*bm (parameter sharing with overlaps — the paper's Fig. 1).
    """

    M: int                    # virtual fan-in   (c_in*p*q on PIM word lines)
    N: int                    # virtual fan-out  (c_out on PIM bit lines)
    m: int                    # epitome rows
    n: int                    # epitome cols
    bm: int = 256             # patch rows  (crossbar word-line count)
    bn: int = 256             # patch cols  (crossbar bit-line count)

    def __post_init__(self):
        if not (0 < self.m <= self.M and 0 < self.n <= self.N):
            raise ValueError(f"epitome ({self.m},{self.n}) must fit in ({self.M},{self.N})")
        if self.bm > self.m or self.bn > self.n:
            raise ValueError(f"patch ({self.bm},{self.bn}) exceeds epitome ({self.m},{self.n})")

    @property
    def gm(self) -> int:
        return -(-self.M // self.bm)

    @property
    def gn(self) -> int:
        return -(-self.N // self.bn)

    @property
    def compression_rate(self) -> float:
        return (self.M * self.N) / (self.m * self.n)

    # -- offsets (static python ints; these ARE the IFRT/IFAT/OFAT content) --
    def row_offsets(self) -> np.ndarray:
        return _spread_offsets(self.m, self.bm, self.gm)

    def col_offsets(self) -> np.ndarray:
        return _spread_offsets(self.n, self.bn, self.gn)

    # -- index maps: virtual coordinate -> epitome coordinate ----------------
    def row_index_map(self) -> np.ndarray:
        return _index_map(self.M, self.bm, self.row_offsets())

    def col_index_map(self) -> np.ndarray:
        return _index_map(self.N, self.bn, self.col_offsets())

    # -- channel wrapping (paper §5.3) ---------------------------------------
    def unique_col_blocks(self) -> Tuple[np.ndarray, np.ndarray]:
        """(unique_offsets, inverse) — column blocks with equal offset are
        byte-identical in W, so ``y`` needs only the unique ones (Eq. 8-9)."""
        offs = self.col_offsets()
        uniq, inverse = np.unique(offs, return_inverse=True)
        return uniq, inverse

    @property
    def wrap_factor(self) -> float:
        """r: how many x fewer output-column blocks need computing."""
        uniq, _ = self.unique_col_blocks()
        return self.gn / max(1, len(uniq))


def _spread_offsets(m: int, bm: int, g: int) -> np.ndarray:
    """g patch offsets evenly spread over [0, m-bm] (all ints, static)."""
    if g <= 1 or m == bm:
        return np.zeros(g, dtype=np.int64)
    span = m - bm
    return np.round(np.linspace(0, span, g)).astype(np.int64)


def _index_map(M: int, bm: int, offsets: np.ndarray) -> np.ndarray:
    """idx[u] = epitome row for virtual row u (static gather table)."""
    idx = np.empty(M, dtype=np.int64)
    for i, off in enumerate(offsets):
        lo = i * bm
        hi = min(M, lo + bm)
        idx[lo:hi] = off + np.arange(hi - lo)
    return idx


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------
def plan_epitome(
    M: int,
    N: int,
    target_cr: float,
    *,
    patch: Tuple[int, int] = (256, 256),
    align: int = 128,
    wrap_cols: bool = True,
) -> Optional[EpitomeSpec]:
    """Choose an epitome shape for a (M, N) weight at roughly ``target_cr``.

    m is a multiple of the patch row count and n of the patch col count
    whenever possible (paper §4.1); ``wrap_cols=True`` prefers n == bn, which
    maximizes output channel wrapping.  Returns None when the layer is too
    small to compress — it then stays dense."""
    if target_cr <= 1.0:
        return None
    bm = min(patch[0], M)
    bn = min(patch[1], N)
    if M >= align:
        bm = max(align, (bm // align) * align)
    if N >= align:
        bn = max(align, (bn // align) * align)
    total = M * N
    budget = total / target_cr

    n_candidates = [bn] if wrap_cols else []
    k = 1
    while k * bn <= N:
        n_candidates.append(k * bn)
        k += 1
    n_candidates = sorted(set(n_candidates))

    best = None
    best_err = math.inf
    for n in n_candidates:
        m_f = budget / n
        for m in {max(bm, int(m_f // bm) * bm), max(bm, -(-int(m_f) // bm) * bm)}:
            m = min(m, M)
            if m * n >= total:      # not actually smaller
                continue
            spec = EpitomeSpec(M=M, N=N, m=m, n=n, bm=bm, bn=bn)
            err = abs(spec.compression_rate - target_cr) / target_cr
            if err < best_err:
                best, best_err = spec, err
    return best


# ---------------------------------------------------------------------------
# Reconstruction & matmul references
# ---------------------------------------------------------------------------
def _index(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.long, device=like.device)


def reconstruct(E: torch.Tensor, spec: EpitomeSpec) -> torch.Tensor:
    """Materialize the virtual weight W (M, N) from the epitome (m, n)."""
    ri = _index(spec.row_index_map(), E)
    ci = _index(spec.col_index_map(), E)
    return E[ri[:, None], ci[None, :]]


def reconstruct_unique(E: torch.Tensor, spec: EpitomeSpec
                       ) -> Tuple[torch.Tensor, np.ndarray]:
    """Materialize only the unique column blocks (channel wrapping, §5.3).

    Returns (W_unique of shape (M, n_unique*bn), inverse block index)."""
    uniq, inverse = spec.unique_col_blocks()
    ri = _index(spec.row_index_map(), E)
    width = min(spec.bn, spec.N)
    ci = _index(np.concatenate([np.arange(off, off + width) for off in uniq]), E)
    return E[ri[:, None], ci[None, :]], inverse


def epitome_matmul_ref(x: torch.Tensor, E: torch.Tensor,
                       spec: EpitomeSpec) -> torch.Tensor:
    """y = x @ W(E): reference without wrapping (full reconstruction)."""
    return x @ reconstruct(E, spec).to(x.dtype)


def wrapped_matmul(x: torch.Tensor, E: torch.Tensor,
                   spec: EpitomeSpec) -> torch.Tensor:
    """y = x @ W(E) computing only unique column blocks, then expanding
    (the paper's output channel wrapping, Eq. 9)."""
    uniq, _ = spec.unique_col_blocks()
    if len(uniq) == spec.gn:
        return epitome_matmul_ref(x, E, spec)     # nothing wraps
    W_u, inverse = reconstruct_unique(E, spec)
    y_u = x @ W_u.to(x.dtype)                     # (..., n_unique*bn)
    pieces = []
    for j in range(spec.gn):
        lo = int(inverse[j]) * spec.bn
        width = min(spec.bn, spec.N - j * spec.bn)
        pieces.append(y_u[..., lo:lo + width])
    return torch.cat(pieces, dim=-1)


def preimage_table(index_map: np.ndarray, size: int) -> np.ndarray:
    """(size, c) table of the positions i with index_map[i] == u for each u
    < size, ascending, c the most any u receives; the padding points at
    position len(index_map), which ``gather_sum`` makes a zero."""
    index_map = np.asarray(index_map)
    n = len(index_map)
    order = np.argsort(index_map, kind="stable")
    counts = np.bincount(index_map, minlength=size)
    rows = index_map[order]
    table = np.full((size, max(1, int(counts.max(initial=0)))), n, dtype=np.int64)
    table[rows, np.arange(n) - (np.cumsum(counts) - counts)[rows]] = order
    return table


class FoldTables(NamedTuple):
    """A spec's index maps and their preimage tables on one device."""
    rmap: torch.Tensor     # (M,) epitome row of each virtual row
    cmap: torch.Tensor     # (N,) epitome column of each virtual column
    rows: torch.Tensor     # (c*m,) preimage_table(rmap, m), column by column
    cols: torch.Tensor     # (c'*n,) preimage_table(cmap, n), column by column


@functools.lru_cache(maxsize=None)
def fold_tables(spec: "EpitomeSpec", device: torch.device) -> FoldTables:
    """Copied to the device once per (spec, device)."""
    rmap, cmap = spec.row_index_map(), spec.col_index_map()
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.long, device=device)
    return FoldTables(put(rmap), put(cmap), put(preimage_table(rmap, spec.m).T.reshape(-1)),
                      put(preimage_table(cmap, spec.n).T.reshape(-1)))


def gather_sum(x: torch.Tensor, table: torch.Tensor, size: int) -> torch.Tensor:
    """(..., size): entry u sums the entries of x's last dim that a
    preimage table (flattened column by column) lists for u, in float32
    and in ascending order, rounded once to x's dtype.  A gather and a sum
    repeat bit for bit on the card, where a scatter-add (``index_add_``)
    adds with atomics in an order that changes from run to run."""
    xp = torch.nn.functional.pad(x, (0, 1))              # the padding's zero
    gathered = xp.index_select(-1, table)
    return gathered.unflatten(-1, (-1, size)).sum(-2, dtype=torch.float32).to(x.dtype)


class _FoldedMatmul(torch.autograd.Function):
    """y = fold(x) @ E, then the column gather, with its gradient written
    out as gathers and products: dy_ep sums dy over each epitome column's
    preimages, dE = fold(x)^T dy_ep, dx = (dy_ep E^T) gathered by the row
    map.  No step scatters, so forward and backward repeat bit for bit."""

    @staticmethod
    def forward(ctx, x, E, spec):
        t = fold_tables(spec, x.device)
        folded = gather_sum(x, t.rows, spec.m)             # (..., m)
        Ec = E.to(x.dtype)
        ctx.save_for_backward(folded, Ec)
        ctx.spec, ctx.E_dtype = spec, E.dtype
        return (folded @ Ec).index_select(-1, t.cmap)      # (..., N)

    @staticmethod
    def backward(ctx, dy):
        folded, Ec = ctx.saved_tensors
        spec = ctx.spec
        t = fold_tables(spec, dy.device)
        dy_ep = gather_sum(dy, t.cols, spec.n)             # (..., n)
        dx = dE = None
        if ctx.needs_input_grad[0]:
            dx = (dy_ep @ Ec.T).index_select(-1, t.rmap)
        if ctx.needs_input_grad[1]:
            dE = (folded.reshape(-1, spec.m).T @ dy_ep.reshape(-1, spec.n)).to(ctx.E_dtype)
        return dx, dE, None


def folded_matmul(x: torch.Tensor, E: torch.Tensor,
                  spec: EpitomeSpec) -> torch.Tensor:
    """Epitome-space matmul: y = fold(x) @ E, then a static column gather.

        y[t, j] = sum_u ( sum_{i in rmap^-1(u)} x[t, i] ) * E[u, cmap[j]]

    The fold gathers each epitome row's preimages and sums them in float32
    (``gather_sum``; the reference's segment_sum), and the gradient is
    gathers and products too (``_FoldedMatmul``); FLOPs and bytes fall by
    about the compression rate.  Exact up to the float32 fold."""
    return _FoldedMatmul.apply(x, E, spec)


# ---------------------------------------------------------------------------
# Overlap statistics (drive the quantization range, paper Fig. 2c / Eq. 4-5)
# ---------------------------------------------------------------------------
def overlap_counts(spec: EpitomeSpec) -> np.ndarray:
    """cnt[u, v] = number of sampled patches covering epitome cell (u, v).
    Separable: cnt = row_cnt (x) col_cnt."""
    def axis_counts(m, bm, offsets, M):
        c = np.zeros(m, dtype=np.int64)
        for i, off in enumerate(offsets):
            used = min(bm, M - i * bm)       # last virtual patch may be ragged
            c[off:off + used] += 1
        return c

    rc = axis_counts(spec.m, spec.bm, spec.row_offsets(), spec.M)
    cc = axis_counts(spec.n, spec.bn, spec.col_offsets(), spec.N)
    return rc[:, None] * cc[None, :]


def overlap_mask(spec: EpitomeSpec) -> np.ndarray:
    """Boolean mask of the 'overlap' (high-repetition) region of E: cells
    covered more often than the minimum positive coverage."""
    cnt = overlap_counts(spec)
    pos = cnt[cnt > 0]
    if pos.size == 0:
        return np.zeros_like(cnt, dtype=bool)
    return cnt > pos.min()


# ---------------------------------------------------------------------------
# Conversion from a dense weight (the epitome designer)
# ---------------------------------------------------------------------------
def epitomize_dense(W: torch.Tensor, spec: EpitomeSpec) -> torch.Tensor:
    """Least-squares init of E from a dense W (M, N): each epitome cell
    becomes the mean of every virtual cell that samples it (the scatter-add
    adjoint of ``reconstruct``, normalized by coverage)."""
    ri = _index(spec.row_index_map(), W)
    ci = _index(spec.col_index_map(), W)
    flat = (ri[:, None] * spec.n + ci[None, :]).reshape(-1)
    sums = W.new_zeros(spec.m * spec.n).index_add_(0, flat, W.reshape(-1))
    cnt = torch.as_tensor(np.maximum(overlap_counts(spec), 1), dtype=W.dtype, device=W.device)
    return sums.reshape(spec.m, spec.n) / cnt


def init_epitome(generator: torch.Generator, spec: EpitomeSpec,
                 dtype=torch.float32, scale: Optional[float] = None,
                 device="cuda") -> torch.Tensor:
    """Fan-in-scaled init; fan-in is the *virtual* M so the reconstructed W
    has the statistics a dense layer would have.  Drawn on the generator's
    device: a CPU generator gives the same epitome on every device, a CUDA
    generator draws a large model on the card without a host copy."""
    if scale is None:
        scale = 1.0 / math.sqrt(spec.M)
    E = torch.randn((spec.m, spec.n), generator=generator, device=generator.device) * scale
    return E.to(device=device, dtype=dtype)
