"""Kernel autotuner: measured pack blocks and fold variant for the epitome
kernels on the card.

The fused int8-epitome matmul is the hot loop of every flagship config, and
its pack blocks are heuristic one-shots (``ops._pick_bk_quant``, the spec's
bn).  This module times ``ops.quant_epitome_matmul`` (kernel #1 plus the
fold, or kernel #2, which folds inside) and ``ops.epitome_matmul`` (kernel
#3) over a candidate (bk, bn) grid, with and without the fused fold, for a
given (legalized spec, quant bits, T bucket), and stamps the winner into
plan provenance, as ``repro.kernels.autotune`` does for the TPU kernels.

The kernels here take no row block: every triple carries the heuristic
``ops._pick_bt`` of its T bucket, so records keep the reference's
(bt, bk, bn) schema and ``EpitomePlan.tuned_blocks()`` reads them alike in
both packages.  The split-K pick (``quant_epitome_matmul.split_rows``) is
not a knob: the plan schema has no field for it.

Correctness contract.  A narrower bn can change the split-K pick and so the
order of the sum; a different bk regroups the scales; kernel #2 sums in its
own order.  The serving contract is bit-exactness, so every candidate's
output is compared with the heuristic blocks' output and, by default, only
outputs equal bit for bit are eligible (``require_bit_identical=False``
opens the full grid and reports max_err, taken against the reconstruct
oracle in float64).  The heuristic candidate always rides in the same
sweep, so ``tuned_us <= heuristic_us`` by construction.  A candidate that a
wrapper's own shape checks refuse before its launch (``ValueError``) is
skipped and listed in ``TuneResult.skipped``; a launch error propagates.

Results persist in a JSON cache, ``benchmarks/tuned/torch-<device
type>.json``, keyed by (spec signature, bits, T bucket) as the reference
keys its own ``<backend>.json``, which this module never reads or writes.
The file records the torch and CUDA versions and the device's name; a
mismatch, a corrupt file or a corrupt entry is a miss (re-tune, never
crash).  A timer that raises or returns a non-finite time degrades the
tuner to the heuristic blocks with ``source='heuristic'``.

    from repro_torch.kernels.autotune import tune, tune_plan
    res = tune(spec, bits=3, T=196)             # TuneResult, on the card
    plan = tune_plan(legal_plan, t=1)           # provenance['tuned_blocks']

``launch/plan.py legalize --tune`` drives ``tune_plan`` from the command
line; the stamped blocks flow through ``EpitomePlan.layer_configs()`` into
``EpLayerConfig.blocks`` and ``fused_fold``.  Entry points time on the card
unless the caller passes ``device='cpu'``, which times the kernels' plain
versions on the host.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.epitome import EpitomeSpec, reconstruct
from ..core.quant import QuantConfig, dequantize_packed
from . import ops

Blocks = Tuple[int, int, int]                  # (bt, bk, bn)

_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "..", "..", "benchmarks", "tuned")


def default_cache_dir() -> str:
    return os.path.normpath(_CACHE_DIR)


def resolve_device(device=None) -> torch.device:
    """The device to time on: the card unless the caller names another.
    Raises where a CUDA device is asked for and none is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible: the tuner times the kernels on "
                           "the card; pass device='cpu' to time their plain "
                           "versions on the host")
    return dev


def backend_of(device: torch.device) -> str:
    return f"torch-{device.type}"


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """One tuning decision, ready for plan provenance (JSON-native)."""
    blocks: Blocks                 # winning (bt, bk, bn)
    fused_fold: bool               # winner uses the in-kernel fold variant
    tuned_us: float                # winner's measured latency
    heuristic_us: float            # the heuristic candidate's latency
    bit_identical: bool            # winner output == heuristic-blocks output
    max_err: float                 # winner vs the reconstruct oracle
    source: str                    # 'timed' | 'cache' | 'heuristic'
    backend: str
    key: str
    # what the sweep saw (not in the record): one dict per candidate run,
    # and the candidates a wrapper's shape checks refused
    sweep: Tuple[Dict[str, Any], ...] = dataclasses.field(default=(), compare=False)
    skipped: Tuple[str, ...] = dataclasses.field(default=(), compare=False)

    def record(self) -> Dict[str, Any]:
        """Provenance/cache form — plain JSON types only, so plans carrying
        it round-trip byte-identically."""
        return {"bt": int(self.blocks[0]), "bk": int(self.blocks[1]),
                "bn": int(self.blocks[2]), "fused_fold": bool(self.fused_fold),
                "tuned_us": float(self.tuned_us),
                "heuristic_us": float(self.heuristic_us),
                "bit_identical": bool(self.bit_identical),
                "max_err": float(self.max_err), "backend": self.backend,
                "key": self.key}


def t_bucket(T: int) -> int:
    """Power-of-two T bucket (min 8): one tuning entry serves every row
    count padding up to the same bucket."""
    return max(8, 1 << (max(1, int(T)) - 1).bit_length())


def spec_signature(spec: EpitomeSpec) -> str:
    return (f"M{spec.M}-N{spec.N}-m{spec.m}-n{spec.n}"
            f"-bm{spec.bm}-bn{spec.bn}")


def tune_key(spec: EpitomeSpec, bits: int, T: int) -> str:
    return f"{spec_signature(spec)}/b{int(bits)}/T{t_bucket(T)}"


# ---------------------------------------------------------------------------
# Candidate grids
# ---------------------------------------------------------------------------
def candidate_blocks(spec: EpitomeSpec, T: int, *, bits: int = 0,
                     tile: int = 256, grid: str = "default") -> List[Blocks]:
    """Candidate (bt, bk, bn) triples, heuristic first.

    The reference's list (the same menus, ``grid='tiny'`` keeping the
    heuristic plus one neighbor per axis) with every bt set to the
    heuristic's, since these kernels take none: the first triple of each
    distinct (bk, bn), in the reference's order.  bn candidates are gated
    by ``col_blocks_splittable`` so every triple samples exactly the
    planned W."""
    Tb = t_bucket(T)
    quant = bits > 0
    h_bt = ops._pick_bt(Tb)
    h_bk = (ops._pick_bk_quant(spec.m, tile) if quant
            else ops._pick_bk(spec.m))
    heur: Blocks = (h_bt, h_bk, spec.bn)

    bk_cap = min(tile, spec.m) if quant else spec.m
    bks = [b for b in ops._BK_BLOCKS if b <= bk_cap]
    bns = [b for b in (512, 256, 128) if b < spec.bn
           and ops.col_blocks_splittable(spec, b)]
    bns = [spec.bn] + bns
    if grid == "tiny":
        bks = bks[:2]
        bns = bns[:1]
    cands = [heur]
    for bk in bks or [h_bk]:
        for bn in bns:
            if (h_bt, bk, bn) not in cands:
                cands.append((h_bt, bk, bn))
    return cands


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------
def _device_of(out) -> Optional[torch.device]:
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (tuple, list)):
        for o in out:
            d = _device_of(o)
            if d is not None:
                return d
    return None


def wall_timer(fn: Callable[[], Any], iters: int) -> float:
    """Default timer: one warm-up call, then the best of ``iters`` calls, in
    µs.  Where fn returns CUDA tensors each call is timed by CUDA events on
    the current stream (the stream fn launches on, whose split-K ticket
    counters it uses), synchronising once per call; otherwise by the host
    clock."""
    dev = _device_of(fn())
    best = float("inf")
    if dev is not None and dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        stream.synchronize()
        for _ in range(max(1, iters)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn()
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        return best
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def _cache_path(cache_dir: str, backend: str) -> str:
    return os.path.join(cache_dir, f"{backend}.json")


def _header(device: torch.device) -> Dict[str, Any]:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return {"backend": backend_of(device), "torch": torch.__version__,
            "cuda": torch.version.cuda, "device": name}


def _load_cache(cache_dir: str, device: torch.device) -> Dict[str, Any]:
    """Entries of the device type's cache file; {} when missing, corrupt, or
    written under another torch, CUDA or device — a stale cache degrades to
    re-tuning, never to serving mistimed blocks."""
    try:
        with open(_cache_path(cache_dir, backend_of(device))) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(d, dict) or any(d.get(k) != v for k, v in _header(device).items()):
        return {}
    entries = d.get("entries")
    return entries if isinstance(entries, dict) else {}


def _save_cache(cache_dir: str, device: torch.device,
                entries: Dict[str, Any]) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    payload = {**_header(device), "entries": entries}
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, _cache_path(cache_dir, backend_of(device)))


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------
def _synthetic_case(spec: EpitomeSpec, T: int, device: torch.device):
    """Deterministic float32 (x, E) for a spec, drawn on ``device`` from a
    generator seeded as the reference seeds its key, so winners are
    comparable across processes on one device type.  Activations are
    fan-in scaled (1/sqrt(M)) so the float32 accumulation error against
    the oracle stays small whatever the contraction depth."""
    g = torch.Generator(device=device).manual_seed(
        spec.M * 1000003 + spec.N * 1009 + spec.m)
    x = torch.randn(T, spec.M, generator=g, device=device) * (spec.M ** -0.5)
    E = torch.randn(spec.m, spec.n, generator=g, device=device)
    return x, E


def _cached_result(hit, backend: str, key: str) -> Optional[TuneResult]:
    """A cache entry as a result; None for a corrupt or partial entry (a
    hand-edited file, an interrupted writer, or a measure/ record), which
    is a miss."""
    try:
        return TuneResult(blocks=(int(hit["bt"]), int(hit["bk"]), int(hit["bn"])),
                          fused_fold=bool(hit["fused_fold"]),
                          tuned_us=float(hit["tuned_us"]),
                          heuristic_us=float(hit["heuristic_us"]),
                          bit_identical=bool(hit["bit_identical"]),
                          max_err=float(hit["max_err"]), source="cache",
                          backend=backend, key=key)
    except (KeyError, TypeError, ValueError):
        return None


def tune(spec: EpitomeSpec, bits: int, T: int, *,
         qcfg: Optional[QuantConfig] = None,
         candidates: Optional[Sequence[Blocks]] = None,
         grid: str = "default", iters: int = 2,
         timer: Optional[Callable[[Callable[[], Any], int], float]] = None,
         require_bit_identical: bool = True,
         include_fused_fold: bool = True,
         cache_dir: Optional[str] = None, force: bool = False,
         device=None) -> TuneResult:
    """Measure the candidate grid for (spec, bits, T bucket) and return the
    winner; a prior winner in the JSON cache short-circuits the sweep
    (``source='cache'``, nothing launched), and a failing timer degrades to
    the heuristic blocks (``source='heuristic'``).  ``bits=0`` tunes the
    float epitome kernel; otherwise the int8 kernels at that weight width.
    Packing happens when a candidate's runner is built, outside the timed
    call."""
    dev = resolve_device(device)
    backend = backend_of(dev)
    cache_dir = default_cache_dir() if cache_dir is None else cache_dir
    key = tune_key(spec, bits, T)
    hit = _load_cache(cache_dir, dev).get(key)
    if hit is not None and not force:
        res = _cached_result(hit, backend, key)
        if res is not None:
            return res

    quant = bits > 0
    qcfg = qcfg if qcfg is not None else (QuantConfig(bits=bits) if quant
                                          else None)
    tile = qcfg.tile if qcfg is not None else 256
    Tb = t_bucket(T)
    cands = list(candidates) if candidates is not None else \
        candidate_blocks(spec, Tb, bits=bits, tile=tile, grid=grid)
    heur = cands[0]
    timer = wall_timer if timer is None else timer

    x, E = _synthetic_case(spec, Tb, dev)

    def runner(blocks: Blocks, fused: bool) -> Callable[[], torch.Tensor]:
        _, bk, bn = blocks
        if quant:
            packed = ops.pack_epitome(E, spec, qcfg, blocks=blocks)
            return lambda: ops.quant_epitome_matmul(x, None, spec, packed=packed,
                                                    fused_fold=fused)
        return lambda: ops.epitome_matmul(x, E, spec, bk=bk, bn=bn)

    def fallback() -> TuneResult:
        return TuneResult(blocks=heur, fused_fold=False, tuned_us=float("nan"),
                          heuristic_us=float("nan"), bit_identical=True,
                          max_err=float("nan"), source="heuristic",
                          backend=backend, key=key)

    with torch.no_grad():
        # the reconstruct oracle, in float64: what every output approximates
        if quant:
            p0 = ops.pack_epitome(E, spec, qcfg)
            W = reconstruct(dequantize_packed(p0.q, p0.scales, p0.zeros,
                                              (p0.bk, p0.bn)).double(), spec)
            del p0
        else:
            W = reconstruct(E.double(), spec)
        oracle = x.double() @ W
        del W
        baseline = runner(heur, False)()

        variants: List[Tuple[Blocks, bool]] = [(c, False) for c in cands]
        if include_fused_fold and quant:
            variants += [(c, True) for c in cands]

        sweep = []                       # (us, idx, blocks, fused, ident, err)
        skipped = []
        for idx, (blocks, fused) in enumerate(variants):
            try:
                fn = runner(blocks, fused)
                out = fn()
            except ValueError as exc:    # refused by a wrapper before launch
                skipped.append(f"{blocks}{'/fold' if fused else ''}: {exc}")
                continue
            ident = bool(torch.equal(out, baseline))
            err = float((out.double() - oracle).abs().max())
            del out
            try:
                us = float(timer(fn, iters))
            except Exception:            # noqa: BLE001 — no clock: the heuristic
                return fallback()
            if not math.isfinite(us):
                return fallback()
            sweep.append((us, idx, blocks, fused, ident, err))
        del x, E, oracle, baseline

    heuristic_us = next(s[0] for s in sweep if s[2] == heur and not s[3])
    eligible = [s for s in sweep if s[4]] if require_bit_identical else sweep
    if not eligible:
        raise AssertionError(f"{key}: the heuristic blocks did not repeat their "
                             f"own output bit for bit")
    us, _, blocks, fused, ident, err = min(eligible, key=lambda s: (s[0], s[1]))
    res = TuneResult(
        blocks=blocks, fused_fold=fused, tuned_us=us, heuristic_us=heuristic_us,
        bit_identical=ident, max_err=err, source="timed", backend=backend, key=key,
        sweep=tuple(dict(bk=b[1], bn=b[2], fused_fold=f, us=u, bit_identical=i,
                         max_err=e) for u, _, b, f, i, e in sweep),
        skipped=tuple(skipped))
    entries = _load_cache(cache_dir, dev)   # re-read: concurrent tuners
    entries[key] = res.record()
    try:
        _save_cache(cache_dir, dev, entries)
    except OSError:
        pass                                 # read-only FS: still usable
    return res


# ---------------------------------------------------------------------------
# Plan integration
# ---------------------------------------------------------------------------
def tune_plan(plan, *, t: int = 1, grid: str = "tiny", iters: int = 2,
              timer=None, include_fused_fold: bool = True,
              cache_dir: Optional[str] = None,
              require_bit_identical: bool = True, device=None):
    """Tune every kernel-mode epitomized layer of a legalized plan and
    stamp the winners into ``provenance['tuned_blocks']`` (schema-additive:
    provenance is free-form, no version bump).  ``t`` is the activation
    batch: conv layers tune at T = t * out_hw^2 rows (their im2col row
    count), fc/LM projections at T = t (the decode batch).  Repeated
    (spec, bits, T-bucket) keys hit the JSON cache, so duplicate layer
    geometries tune once."""
    from ..pim.plan import inventory_for
    layers = inventory_for(plan.arch)()
    records: Dict[str, Any] = {}
    for l, lp in zip(layers, plan.layers):
        if lp.spec is None or lp.mode != "kernel":
            continue
        T = t * l.rounds if l.kind == "conv" else max(1, t)
        res = tune(lp.spec, lp.weight_bits or 0, T, grid=grid, iters=iters,
                   timer=timer, include_fused_fold=include_fused_fold,
                   cache_dir=cache_dir,
                   require_bit_identical=require_bit_identical, device=device)
        records[lp.name] = {**res.record(), "T": int(T),
                            "source": res.source}
    return dataclasses.replace(plan, provenance={**plan.provenance,
                                                 "tuned_blocks": records})
