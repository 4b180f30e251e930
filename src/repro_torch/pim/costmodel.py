"""One cost interface for plan search and plan artifacts.

``CostModel`` is what the evolution search ranks by (``total()``, seconds)
and what planners stamp into ``provenance['cost']`` (``plan_cost()``):

  * ``AnalyticCost``  — wraps the ``PimSimulator``'s linear latency model,
                        per layer.
  * ``MeasuredCost``  — per-layer kernel latency timed on the card (the
                        autotuner's ``wall_timer``, CUDA events), memoized
                        per *legalized* ``(spec signature, weight_bits, T
                        bucket)`` and persisted in the autotuner's cache
                        file (``benchmarks/tuned/torch-<device type>.json``,
                        namespaced ``measure/...`` entries), so identical
                        candidates across search generations are timed
                        once, and ``legalize --tune`` winners are reused as
                        measurements.  A failing timer degrades to analytic
                        scoring with a visible warning, never a crash;
                        corrupt or stale cache entries re-time.

The counterpart of ``repro.pim.costmodel``, name for name: the same keys,
the same order of timer calls and the same records, so a search with a
deterministic injected timer writes the same plan in both packages.
``pim`` stays importable without touching torch.cuda: the kernel modules
are imported inside the methods that time.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.epitome import EpitomeSpec
from .simulator import PimSimulator
from .workloads import LayerShape

# cost-model measurements live in the autotuner's cache file under this
# namespace, so they never masquerade as tuned sweep winners (a real tuned
# winner for the same key IS reused as the measurement — it is the latency
# the plan will serve at)
MEASURE_PREFIX = "measure/"


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """One layer's cost under a CostModel, ready for provenance."""
    name: str
    analytic_s: float                 # simulator latency, seconds
    measured_s: Optional[float]       # measured kernel latency; None when
                                      # the backend is analytic-only or the
                                      # timer is unavailable
    key: str = ""                     # memo/cache key ("" for analytic)
    source: str = "analytic"          # analytic | timed | cache | memo

    def record(self) -> Dict[str, Any]:
        return {"name": self.name, "analytic_s": float(self.analytic_s),
                "measured_s": (None if self.measured_s is None
                               else float(self.measured_s)),
                "key": self.key, "source": self.source}


@dataclasses.dataclass
class PlanCost:
    """A whole plan's cost record (what provenance['cost'] stores)."""
    model: str                        # 'analytic' | 'measured'
    t: int                            # activation batch the T's derive from
    layers: List[LayerCost]

    @property
    def analytic_s(self) -> float:
        return sum(c.analytic_s for c in self.layers)

    @property
    def measured_s(self) -> Optional[float]:
        vals = [c.measured_s for c in self.layers]
        if any(v is None for v in vals):
            return None
        return sum(vals)

    def record(self) -> Dict[str, Any]:
        m = self.measured_s
        return {"model": self.model, "t": int(self.t),
                "analytic_s": float(self.analytic_s),
                "measured_s": None if m is None else float(m),
                "layers": [c.record() for c in self.layers]}


def _norm_bits(bits, n: int) -> List[Optional[int]]:
    if bits is None:
        return [None] * n
    return list(bits)


class CostModel:
    """Interface every plan-scoring backend implements.

    ``total()`` is the scalar the evolution search ranks by (seconds;
    ``None`` means this backend cannot score right now — callers degrade
    to analytic).  ``plan_cost()`` is the provenance form.
    """

    name = "abstract"

    def layer_costs(self, layers: Sequence[LayerShape],
                    specs: Sequence[Optional[EpitomeSpec]],
                    bits=None, *, t: Optional[int] = None,
                    act_bits: Optional[int] = None,
                    wrapping: bool = True) -> List[LayerCost]:
        raise NotImplementedError

    def total(self, layers, specs, bits=None, *, t: Optional[int] = None,
              act_bits: Optional[int] = None,
              wrapping: bool = True) -> Optional[float]:
        raise NotImplementedError

    def plan_cost(self, plan, *, t: Optional[int] = None) -> PlanCost:
        from .plan import inventory_for
        layers = inventory_for(plan.arch)()
        lcs = self.layer_costs(layers, plan.specs(), plan.bits(), t=t,
                               act_bits=plan.provenance.get("act_bits"))
        return PlanCost(self.name, t if t is not None else getattr(self, "t", 1),
                        lcs)


class AnalyticCost(CostModel):
    """The PimSimulator's linear latency model, per layer."""

    name = "analytic"

    def __init__(self, simulator: PimSimulator):
        self.sim = simulator

    def layer_costs(self, layers, specs, bits=None, *, t=None, act_bits=None,
                    wrapping=True) -> List[LayerCost]:
        bits = _norm_bits(bits, len(layers))
        cs = self.sim.counters(layers, specs, bits, wrapping, act_bits)
        co = self.sim.coeff
        return [LayerCost(c.name, float(co.A * c.R + co.B * c.V), None)
                for c in cs]

    def total(self, layers, specs, bits=None, *, t=None, act_bits=None,
              wrapping=True) -> float:
        return sum(c.analytic_s for c in self.layer_costs(
            layers, specs, bits, act_bits=act_bits, wrapping=wrapping))




class MeasuredCost(CostModel):
    """Measured kernel latency, memoized and cache-persisted.

    Per layer: the searched spec is legalized to the kernel-exact family at
    ``patch`` (what would actually run), keyed by the autotuner's
    ``tune_key`` (legalized spec signature, per-layer weight_bits, T
    bucket), and timed once — first checking the in-process memo, then the
    autotuner's cache file (a tuned sweep winner for the same key is reused
    directly; otherwise a ``measure/``-namespaced entry), and only then
    invoking ``timer`` on the kernel's wrapper.  Dense layers time a dense
    matmul at (T bucket, rows) x (rows, cols).  ``device`` is where the
    runners live: the card unless the caller names another.

    A failing/NaN timer flips ``available`` off with one visible warning;
    every subsequent lookup returns ``measured_s=None`` immediately so the
    caller's analytic fallback costs nothing.  Corrupt cache entries are
    treated as misses and re-timed.
    """

    name = "measured"

    def __init__(self, simulator: PimSimulator, *,
                 patch: Tuple[int, int], t: int = 1, iters: int = 2,
                 timer: Optional[Callable[[Callable[[], Any], int], float]]
                 = None,
                 cache_dir: Optional[str] = None, qtile: int = 256,
                 device=None):
        self.analytic = AnalyticCost(simulator)
        self.sim = simulator
        self.patch = tuple(patch)
        self.t = int(t)
        self.iters = int(iters)
        self._timer = timer
        self._cache_dir = cache_dir
        self.qtile = int(qtile)
        self.device = device
        self.available = True
        self.timings = 0              # timer invocations (== unique timed keys)
        self.lookups = 0              # per-layer cost lookups (dedup stat)
        self._memo: Dict[str, Tuple[Optional[float], str]] = {}

    # -- keying --------------------------------------------------------------
    def _layer_T(self, layer: LayerShape, t: Optional[int]) -> int:
        """Activation rows a layer's kernel sees: conv layers run their
        im2col row count per image (t * out_hw^2), fc/LM projections the
        decode batch — exactly ``kernels.autotune.tune_plan``'s convention,
        so keys line up with ``legalize --tune`` entries."""
        t = self.t if t is None else int(t)
        return t * layer.rounds if layer.kind == "conv" else max(1, t)

    def _resolve(self, layer: LayerShape, spec: Optional[EpitomeSpec],
                 t: Optional[int]) -> Tuple[Optional[EpitomeSpec], int]:
        """(legalized spec | None, T) for one layer.  Legalizing before
        keying is what dedupes 'identical candidates': two searched specs
        snapping to the same kernel-exact family share one timing."""
        from .plan import legalize_spec
        T = self._layer_T(layer, t)
        legal = None
        if spec is not None:
            legal, _ = legalize_spec(layer, spec, self.patch)
        return legal, T

    def _key_of(self, layer: LayerShape, legal: Optional[EpitomeSpec],
                bits: Optional[int], T: int) -> str:
        from ..kernels.autotune import t_bucket, tune_key
        if legal is None:
            return (f"dense/M{layer.rows}-N{layer.cols}"
                    f"/b{int(bits or 0)}/T{t_bucket(T)}")
        return tune_key(legal, int(bits or 0), T)

    def layer_key(self, layer: LayerShape, spec: Optional[EpitomeSpec],
                  bits: Optional[int], *, t: Optional[int] = None) -> str:
        """The memo/cache key of one (layer, spec, weight_bits) — public so
        tests and tools can assert keying (e.g. that per-layer bits from
        LayerPlan distinguish heterogeneous-bit plans)."""
        legal, T = self._resolve(layer, spec, t)
        return self._key_of(layer, legal, bits, T)

    # -- timing --------------------------------------------------------------
    def _timer_fn(self):
        if self._timer is not None:
            return self._timer
        from ..kernels.autotune import wall_timer
        return wall_timer

    def _cache_dir_resolved(self) -> str:
        if self._cache_dir is not None:
            return self._cache_dir
        from ..kernels.autotune import default_cache_dir
        return default_cache_dir()

    def _dev(self):
        from ..kernels.autotune import resolve_device
        return resolve_device(self.device)

    def _build_runner(self, layer: LayerShape,
                      legal: Optional[EpitomeSpec],
                      bits: Optional[int], T: int) -> Callable[[], Any]:
        import torch
        from ..core.quant import QuantConfig
        from ..kernels import ops
        from ..kernels.autotune import _synthetic_case, t_bucket
        dev = self._dev()
        Tb = t_bucket(T)
        if legal is None:
            g = torch.Generator(device=dev).manual_seed(layer.rows * 1000003 + layer.cols)
            x = torch.randn(Tb, layer.rows, generator=g, device=dev) \
                * (layer.rows ** -0.5)
            W = torch.randn(layer.rows, layer.cols, generator=g, device=dev)
            return lambda: x @ W
        x, E = _synthetic_case(legal, Tb, dev)
        if bits:
            packed = ops.pack_epitome(E, legal, QuantConfig(bits=int(bits),
                                                            tile=self.qtile))
            return lambda: ops.quant_epitome_matmul(x, None, legal, packed=packed)
        return lambda: ops.epitome_matmul(x, E, legal)

    def _degrade(self, exc: BaseException) -> None:
        if self.available:
            warnings.warn(
                f"measured cost unavailable ({exc!r}); degrading to "
                f"analytic scoring — plans still legalize and run, their "
                f"provenance records measured_s=null", stacklevel=3)
        self.available = False

    def _timed(self, fn) -> float:
        import torch
        with torch.no_grad():
            us = float(self._timer_fn()(fn, self.iters))
        if not us == us or us in (float("inf"), float("-inf")):
            raise ValueError(f"timer returned {us!r}")
        return us

    def _measure(self, layer: LayerShape, legal: Optional[EpitomeSpec],
                 bits: Optional[int], T: int,
                 key: str) -> Tuple[Optional[float], str]:
        """Measured microseconds for one key (None when unavailable)."""
        self.lookups += 1
        hit = self._memo.get(key)
        if hit is not None:
            us, src = hit
            return us, ("memo" if src == "timed" else src)
        if not self.available:
            self._memo[key] = (None, "analytic")
            return None, "analytic"

        from ..kernels import autotune
        dev = self._dev()
        cache_dir = self._cache_dir_resolved()
        entries = autotune._load_cache(cache_dir, dev)
        us = _cached_tuned_us(entries, key)
        if us is None:
            us = _cached_measure_us(entries, MEASURE_PREFIX + key)
        if us is not None:
            self._memo[key] = (us, "cache")
            return us, "cache"

        try:
            us = self._timed(self._build_runner(layer, legal, bits, T))
        except Exception as exc:           # noqa: BLE001 — degrade, don't die
            self._degrade(exc)
            self._memo[key] = (None, "analytic")
            return None, "analytic"
        self.timings += 1
        # persist (re-read first: concurrent tuners/cost models share the file)
        entries = autotune._load_cache(cache_dir, dev)
        entries[MEASURE_PREFIX + key] = {"us": us, "kind": "costmodel"}
        try:
            autotune._save_cache(cache_dir, dev, entries)
        except OSError:
            pass                            # read-only FS: memo still works
        self._memo[key] = (us, "timed")
        return us, "timed"

    def _shape_sig(self, layer: LayerShape, legal: Optional[EpitomeSpec],
                   bits: Optional[int], T: int) -> Tuple:
        """What makes two runners 'the same kernel at the same shapes'.
        Dense runners ignore weight bits (they time a float matmul), so
        bit variants of one dense geometry share a group; epitome runners
        are shaped by the full spec geometry plus the quantization."""
        from ..kernels.autotune import t_bucket
        Tb = t_bucket(T)
        if legal is None:
            return ("dense", Tb, layer.rows, layer.cols)
        return ("epi", Tb, int(bits or 0), legal.M, legal.N,
                legal.m, legal.n, legal.bm, legal.bn)

    def prime(self, layers: Sequence[LayerShape],
              candidates: Sequence[Sequence[Optional[EpitomeSpec]]],
              bits=None, *, t: Optional[int] = None) -> int:
        """Batch-measure every still-unknown key across a set of candidate
        spec vectors (the elite front) before per-candidate scoring.

        Same-shaped runners are timed together: one callable runs a group's
        runners in turn and is timed with one timer call, and the group's
        time splits evenly across its members (same shapes => the same
        kernel repeated => the same per-member latency a solo timing would
        report).  Cache keys, the persisted entry format, and timed-once
        semantics are unchanged — subsequent ``layer_costs``/``total``
        calls hit the memo and never re-time.  Returns the number of groups
        timed (0 when everything was already known, or the backend has
        degraded)."""
        if not self.available:
            return 0
        from ..kernels import autotune
        bits_l = _norm_bits(bits, len(layers))
        dev = self._dev()
        cache_dir = self._cache_dir_resolved()
        entries = autotune._load_cache(cache_dir, dev)
        pending: Dict[str, Tuple[LayerShape, Optional[EpitomeSpec],
                                 Optional[int], int]] = {}
        for specs in candidates:
            for l, s, b in zip(layers, specs, bits_l):
                legal, T = self._resolve(l, s, t)
                key = self._key_of(l, legal, b, T)
                if key in self._memo or key in pending:
                    continue
                us = _cached_tuned_us(entries, key)
                if us is None:
                    us = _cached_measure_us(entries, MEASURE_PREFIX + key)
                if us is not None:
                    self._memo[key] = (us, "cache")
                    continue
                pending[key] = (l, legal, b, T)
        if not pending:
            return 0
        groups: Dict[Tuple, List[str]] = {}
        runners: Dict[str, Callable[[], Any]] = {}
        for key, (l, legal, b, T) in pending.items():
            try:
                runners[key] = self._build_runner(l, legal, b, T)
            except Exception as exc:       # noqa: BLE001 — degrade, don't die
                self._degrade(exc)
                for k in pending:
                    self._memo.setdefault(k, (None, "analytic"))
                return 0
            groups.setdefault(self._shape_sig(l, legal, b, T),
                              []).append(key)
        timed = 0
        for keys in groups.values():
            fns = tuple(runners[k] for k in keys)
            try:
                us = self._timed(lambda fns=fns: tuple(f() for f in fns))
            except Exception as exc:       # noqa: BLE001
                self._degrade(exc)
                for k in keys:
                    self._memo[k] = (None, "analytic")
                continue
            self.timings += 1
            timed += 1
            share = us / len(keys)
            entries = autotune._load_cache(cache_dir, dev)
            for k in keys:
                entries[MEASURE_PREFIX + k] = {"us": share,
                                               "kind": "costmodel"}
                self._memo[k] = (share, "timed")
            try:
                autotune._save_cache(cache_dir, dev, entries)
            except OSError:
                pass                        # read-only FS: memo still works
        return timed

    # -- CostModel interface -------------------------------------------------
    def layer_costs(self, layers, specs, bits=None, *, t=None, act_bits=None,
                    wrapping=True) -> List[LayerCost]:
        bits = _norm_bits(bits, len(layers))
        base = self.analytic.layer_costs(layers, specs, bits,
                                         act_bits=act_bits, wrapping=wrapping)
        out: List[LayerCost] = []
        for l, s, b, a in zip(layers, specs, bits, base):
            legal, T = self._resolve(l, s, t)
            key = self._key_of(l, legal, b, T)
            us, source = self._measure(l, legal, b, T, key)
            out.append(LayerCost(l.name, a.analytic_s,
                                 None if us is None else us * 1e-6,
                                 key, source))
        return out

    def total(self, layers, specs, bits=None, *, t=None, act_bits=None,
              wrapping=True) -> Optional[float]:
        lcs = self.layer_costs(layers, specs, bits, t=t, act_bits=act_bits,
                               wrapping=wrapping)
        vals = [c.measured_s for c in lcs]
        if any(v is None for v in vals):
            return None
        return sum(vals)


def _cached_tuned_us(entries: Dict[str, Any], key: str) -> Optional[float]:
    """A prior autotune sweep winner's latency for this exact key, or None.
    Corrupt/partial entries are misses, never crashes."""
    try:
        us = float(entries[key]["tuned_us"])
    except (KeyError, TypeError, ValueError):
        return None
    return us if us == us and us != float("inf") else None


def _cached_measure_us(entries: Dict[str, Any], key: str) -> Optional[float]:
    try:
        us = float(entries[key]["us"])
    except (KeyError, TypeError, ValueError):
        return None
    return us if us == us and us != float("inf") else None


# ---------------------------------------------------------------------------
# Factories — the arch-default backends launch/plan.py and tests build
# ---------------------------------------------------------------------------
def analytic_cost_for(arch: str) -> AnalyticCost:
    from .plan import simulator_for
    return AnalyticCost(simulator_for(arch))


def measured_cost_for(arch: str, *, t: int = 1, iters: int = 2,
                      timer=None, cache_dir: Optional[str] = None,
                      device=None) -> MeasuredCost:
    from .plan import exec_patch_for, simulator_for
    return MeasuredCost(simulator_for(arch), patch=exec_patch_for(arch),
                        t=t, iters=iters, timer=timer, cache_dir=cache_dir,
                        device=device)


def cost_model_for(arch: str, kind: str = "analytic", **kw) -> CostModel:
    """'analytic' | 'measured' backend for an arch (the ``--measured``
    command-line switch resolves here)."""
    if kind == "analytic":
        return analytic_cost_for(arch)
    if kind == "measured":
        return measured_cost_for(arch, **kw)
    raise ValueError(f"unknown cost model {kind!r}; "
                     "expected 'analytic' or 'measured'")
