"""Each kernel's work, whatever implements it, and the card's rates.

For every hand-written kernel: the bytes a launch must move (each input
read once, each output written once) and the operations it does, as
functions of its shapes; the H100 SXM5's data-sheet rates; and the least
time a launch could take on them (``bound_seconds``).  ``chip_smoke.py``
bounds its measured kernels with these, and the dry run
(``launch.dryrun``) counts a traced step's kernels with them.

The shape-only branch.  A kernel wrapper given a fake tensor
(``shape_only``: ``FakeTensorMode``'s, as the dry run traces a step)
launches nothing and runs no plain version: it returns empty outputs of
the kernel's shapes and dtypes and adds its launch, operations and bytes
to the ``Recorder`` the dry run installs (``recording``).  A real tensor
never takes it: on the CPU it runs the plain version, on a card the
kernel, and on the ``meta`` device, with no fake mode, it is refused as
before.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

# An NVIDIA H100 80GB HBM3 (SXM5): its data sheet, and a DGX H100's network
BF16_TC_FLOPS = 989e12      # bf16 tensor cores, dense
TF32_TC_FLOPS = 495e12      # TF32 tensor cores, dense
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
HBM_BW = 3.35e12            # B/s, HBM3
HBM_BYTES = 80 * 2**30      # capacity
NVLINK_BW = 900e9           # B/s, NVLink 4 (18 links, both directions together)
IB_BW = 50e9                # B/s, one 400 Gb/s NDR InfiniBand adapter a card

# kernels whose operands are int8 codes, exact in bf16: their operations
# run at the bf16 tensor-core rate
TC_KERNELS = ("quant_epitome_matmul_blocks", "quant_epitome_matmul_fused_fold", "quant_matmul")
FP_KERNEL = "epitome_matmul_blocks"
WKV, WKV_BWD, SCAN, SCAN_BWD = ("wkv6_chunked", "wkv6_chunked_bwd", "mamba_scan",
                                "mamba_scan_bwd")


# -- the epitome and int8 products (kernels #1, #2, #3, #5) -----------------------
def quant_epitome_work(T: int, m: int, n: int, gn: int, bn: int, distinct: int,
                       scale_blocks: int, esz: int) -> Tuple[float, float]:
    """Kernel #1: (bytes, FLOPs) of a (T, m) folded activation of ``esz``
    bytes an element against (m, n) int8 codes with ``scale_blocks``
    float32 (scale, zero) pairs and ``gn`` column blocks of ``bn``, written
    in the activation's dtype.  A column block that repeats an epitome
    block (``distinct`` of the gn differ) is one product, counted once."""
    nbytes = esz * T * m + m * n + 8.0 * scale_blocks + 4.0 * gn + esz * T * gn * bn
    return nbytes, 2.0 * T * m * distinct * bn


def fused_fold_work(T: int, M: int, m: int, n: int, gn: int, bn: int, distinct: int,
                    scale_blocks: int, gm: int) -> Tuple[float, float]:
    """Kernel #2: kernel #1's product from the unfolded float32 (T, M)
    activation (one add a virtual row more), with ``gm`` row offsets."""
    nbytes = 4.0 * T * M + m * n + 8.0 * scale_blocks + 4.0 * gn + 4.0 * gm + 4.0 * T * gn * bn
    return nbytes, 2.0 * T * m * distinct * bn + T * M


def epitome_work(T: int, m: int, n: int, gn: int, bn: int, distinct: int,
                 esz: int) -> Tuple[float, float]:
    """Kernel #3: a (T, m) folded activation against the (m, n) epitome, one
    dtype of ``esz`` bytes for both and the output."""
    return esz * (T * m + m * n + T * gn * bn) + 4.0 * gn, 2.0 * T * m * distinct * bn


def quant_matmul_work(T: int, M: int, N: int, tiles: int, esz: int) -> Tuple[float, float]:
    """Kernel #5: (T, M) against (M, N) int8 codes with ``tiles`` (scale,
    zero) pairs, the output in the activation's dtype."""
    return esz * T * M + M * N + 8.0 * tiles + esz * T * N, 2.0 * T * M * N


# -- the WKV (kernel #4) and its gradient (#4b) --------------------------------------
def wkv6_ops(B: int, S: int, H: int, K: int, L: int) -> Tuple[float, float]:
    """Operations of the reference's chunked WKV (whatever the kernel
    implements), per (batch, head, chunk of L tokens): the cumsum and
    cs_prev (2LK), the decayed r (2LK), the inter-chunk product (2LK^2), the
    strictly causal scores (L(L-1)/2 pairs of K terms: subtract, exp, two
    multiplies, add), their product with v (2 pairs K), the bonus (5LK), the
    decayed k (3LK) and the state (2LK^2 + 2K^2).  Returns (all, products):
    the four chunk products are the inter-chunk, the scores' multiply-add
    (2 pairs K), scores @ v and the state's 2LK^2."""
    pairs = L * (L - 1) // 2
    per = (4 * L * K + 2 * L * K * K + 5 * pairs * K + 2 * pairs * K + 8 * L * K
           + 2 * L * K * K + 2 * K * K)
    products = 2 * L * K * K + 2 * pairs * K + 2 * pairs * K + 2 * L * K * K
    n = B * H * -(-S // L)
    return float(n * per), float(n * products)


def wkv6_bytes(B: int, S: int, H: int, K: int, esz: int, h0: bool = True) -> float:
    """r, k, v read in their dtype (``esz`` bytes); logw read and o written
    in float32; u; h0 read (if given) and hT written."""
    n = B * S * H * K
    return 3.0 * esz * n + 4.0 * (2 * n + H * K) + 4.0 * B * H * K * K * (2 if h0 else 1)


def wkv_bwd_ops(B: int, S: int, H: int, K: int) -> float:
    """Operations of the WKV's gradient as the token recurrence computes it
    (kernels/ref.py, wkv6_chunked_bwd_ref), per (batch, token, head): the
    state forward (S w, k v, their sum: 3 K^2), dr's, dk's and dv's products
    with a state (2 K^2 each), dlogw's (2 K^2) and dS's update (3 K^2), plus
    the per-channel terms (do . v, the bonus, u k dov, r u dov, du, w's
    product and the sums: 18 K).  Its fp32-rate bound."""
    return float(B * S * H * (14 * K * K + 18 * K))


def wkv_bwd_chunked_ops(B: int, S: int, H: int, K: int, L: int = 64) -> Tuple[float, float]:
    """Operations of the WKV's gradient in the chunked form the kernel
    computes (csrc/wkv6_bwd.cu), per (batch, head, chunk of L tokens), with
    P = L(L-1)/2 causal pairs: ten products, the five over pairs (the
    scores, dA = do v^T, A^T do, dr's and dk's through dA: 2 P K each) and
    the five with a state (do S0^T, v dS^T, the decayed k's dS, dS0's r^T
    do, sweep 1's state update: 2 L K^2 each); the rest, the pairs' decays
    (subtract, exp and three multiplies: 5 P K), the two cumsums (2 L K),
    the decayed operands of the state products (5 L K + 4 K^2), the bonus
    terms, do . v, du, P, Q and the dlogw scan (20 L K) and C (2 K^2).
    Returns (all, products)."""
    pairs = L * (L - 1) // 2
    products = 5 * 2 * pairs * K + 5 * 2 * L * K * K
    rest = 5 * pairs * K + 27 * L * K + 6 * K * K
    n = B * H * -(-S // L)
    return float(n * (products + rest)), float(n * products)


def wkv_bwd_bytes(B: int, S: int, H: int, K: int, esz: int, h0: bool, dhT: bool) -> float:
    """r, k, v read in their dtype; logw and do read in float32; u; h0 and
    dhT read where given; dr, dk, dv, dlogw, du and dh0 written in float32
    (the stored chunk states, scratch, not counted)."""
    n = B * S * H * K
    return (3.0 * esz * n + 4.0 * 2 * n + 4.0 * H * K + 4.0 * B * H * K * K * (h0 + dhT)
            + 4.0 * 4 * n + 4.0 * H * K + 4.0 * B * H * K * K)


# -- the Mamba scan (kernel #6) ---------------------------------------------------
def scan_ops(B: int, S: int, di: int, ds: int) -> float:
    """Operations of the selective scan, per (batch, token, channel): per
    state dt A, its exponential, (dt x) B, the state's multiply-add and the
    C contraction's (7 ds), and dt x, D x and its add (3)."""
    return float(B * S * di * (7 * ds + 3))


def scan_bytes(B: int, S: int, di: int, ds: int, esz: int, h0: bool = True) -> float:
    """dt and x read in their dtype (esz bytes), B and C too, A and D, h0
    read (if given) and hT written, y written in float32."""
    return (2.0 * esz * B * S * di + 2.0 * esz * B * S * ds + 4.0 * (di * ds + di)
            + 4.0 * B * di * ds * (2 if h0 else 1) + 4.0 * B * S * di)


def scan_bwd_work(B: int, S: int, di: int, ds: int, esz: int, h0: bool) -> Tuple[float, float]:
    """The scan's gradient, which has no kernel yet (ROADMAP item 7.13): an
    estimate, the forward's operations twice (its recompute and the
    adjoint recurrence) and its bytes with dy read and every input's
    gradient written in float32."""
    nbytes = (scan_bytes(B, S, di, ds, esz, h0) + 4.0 * B * S * di
              + 4.0 * (2 * B * S * di + 2 * B * S * ds + di * ds + di)
              + (4.0 * B * di * ds if h0 else 0.0))
    return nbytes, 2.0 * scan_ops(B, S, di, ds)


# -- the bound --------------------------------------------------------------------
def tc_seconds(name: str, flops: float, dtype: str = "float32", products=None) -> float:
    """The tensor-core time of a kernel's FLOPs: the int8-code kernels at
    the bf16 rate, kernel #3 at 3 x FLOPs over the TF32 rate for float32
    (3xTF32) or at the bf16 rate for bf16, and the WKV's four chunk
    ``products`` at 3 x FLOPs over the TF32 rate or the rest of its FLOPs at
    the fp32 rate, whichever is longer.  For the WKV's gradient ``products``
    is its chunked form's (all, products), taken the same way; ``flops``,
    the token form's count, sets its fp32-rate bound.  The Mamba scan has
    no products: all its operations at the fp32 rate."""
    if name in TC_KERNELS or (name == FP_KERNEL and dtype == "bfloat16"):
        return flops / BF16_TC_FLOPS
    if name == FP_KERNEL:
        return 3 * flops / TF32_TC_FLOPS
    if name == WKV:
        return max(3 * products / TF32_TC_FLOPS, (flops - products) / FP32_FLOPS)
    if name == WKV_BWD:      # its chunked form's (all, products): wkv_bwd_chunked_ops
        chunked, products = products
        return max(3 * products / TF32_TC_FLOPS, (chunked - products) / FP32_FLOPS)
    if name in (SCAN, SCAN_BWD):   # elementwise float32 work, exponentials one each
        return flops / FP32_FLOPS
    raise ValueError(f"no tensor-core bound for {name}")


def bound_seconds(name: str, nbytes: float, flops: float, dtype: str = "float32",
                  products=None) -> Tuple[float, str]:
    """(the least time a launch could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over the
    peak of their type (``tc_seconds``)."""
    t_bytes = nbytes / HBM_BW
    t_ops = tc_seconds(name, flops, dtype, products)
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


# -- the shape-only branch and its recorder -----------------------------------------
def shape_only(t) -> bool:
    """True for a fake tensor (``FakeTensorMode``'s), tested as such: its
    device reads as the one it fakes, the CPU or the ``meta`` device, and
    it has no data to launch a kernel on or to run a plain version over.
    A plain tensor, what every real call passes, is answered by its type."""
    return type(t) is not torch.Tensor and is_fake(t)


class Recorder:
    """What the kernels of a traced step would do: {kernel: {launches,
    flops, bytes, bound_s}}, each launch's work from this module."""

    def __init__(self):
        self.kernels: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, nbytes: float, flops: float, dtype: str = "float32",
            products=None) -> None:
        k = self.kernels.setdefault(name, dict(launches=0, flops=0.0, bytes=0.0, bound_s=0.0))
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        k["bound_s"] += bound_seconds(name, nbytes, flops, dtype, products)[0]


_RECORDER: Optional[Recorder] = None


@contextlib.contextmanager
def recording():
    """Install a fresh ``Recorder`` for the shape-only branches while
    inside; yields it."""
    global _RECORDER
    before, _RECORDER = _RECORDER, Recorder()
    try:
        yield _RECORDER
    finally:
        _RECORDER = before


def record(name: str, nbytes: float, flops: float, dtype: str = "float32",
           products=None) -> None:
    """A shape-only launch of ``name``, added to the installed recorder
    (with none installed, nothing is kept)."""
    if _RECORDER is not None:
        _RECORDER.add(name, nbytes, flops, dtype, products)


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")
