"""EpitomePlan — the repo's central plan -> legalize -> execute artifact.

The paper's layer-wise design method (Algorithm 1) produces per-layer
epitome shapes, but a searched design is only useful if it can *run*: the
fused kernels are exact only for the bn-aligned column families
(wrap: n == bn, every output block samples epitome block 0; identity:
n == N with N % bn == 0, distinct aligned blocks — row offsets stay free
because fold_rows is exact for any row map).  This module closes that loop,
PIMCOMP-style:

  * ``EpitomePlan`` — a serializable (JSON, schema-checked) record of one
    deployment design: per-layer {spec, weight_bits, mode} + provenance +
    the simulator's predicted latency/energy/#XB.  Every planner emits one:
    ``uniform_plan`` (the paper's 1024x256 design), ``auto_plan`` (the
    kernel-exact CR-targeted designer, ex models.resnet.plan_conv_specs),
    and ``search_plan`` (Algorithm-1 evolution search).
  * ``legalize_plan`` — snaps any searched spec to the kernel-exact
    families at the target execution patch, reporting the per-layer snap
    error (relative epitome-area change) and re-simulating the cost, so
    every plan can execute through the fused int8 kernel, not just
    reconstruct.
  * ``ResNetModel.from_plan`` / ``configs.get_resnet(..., plan=...)`` /
    ``launch/plan.py`` consume plans and run them end to end.

A copy of ``repro.pim.plan``: plan JSON written by either package loads
in the other, and a search or a legalization gives the same plan in both.
A plan's placements are applied on a mesh (``launch.mesh.mesh_for_plan``,
``lm.prepack_params(mesh=)``) and carried otherwise.

LM plans work the same way: every configs/archs.py architecture registers
a plan arch (``"<arch>"``, plus ``"<arch>-smoke"`` for the reduced smoke
geometry) whose inventory (``workloads.lm_layers``) enumerates the
attention/ffn projections per super-block, named by param-tree path.
``EpitomePlan.layer_configs()`` turns a plan into the per-layer
``ModelConfig.layer_config`` that ``get_config(..., plan=...)`` installs,
and ``lm.prepack_params`` serves it weight-stationary.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.epitome import EpitomeSpec
from ..core.placement import (LayerPlacement, MESH_AXES, SCALE_MODES,
                              default_placement, snap_placement)
from .costmodel import AnalyticCost, CostModel
from .evo import EvoConfig, candidate_specs, evolution_search
from .simulator import (PimSimulator, default_calibrated_simulator,
                        tiny_calibrated_simulator)
from .workloads import (LayerShape, lm_layers, resnet50_layers,
                        resnet101_layers, tiny_resnet_layers)
from .xbar import MappingConfig, count_crossbars, uniform_epitome_specs

# version 2: per-layer placement records
PLAN_VERSION = 2
MODES = ("reconstruct", "wrapped", "folded", "kernel")

# LM plan arches: one per configs/archs.py builder, plus a "<arch>-smoke"
# variant planning the reduced get_smoke_config geometry (the CPU-testable
# half of the pipeline).  Kept as a static tuple so this module imports no
# model code; a registry cross-check test guards against drift.
LM_SMOKE_SUFFIX = "-smoke"
LM_ARCHS = ("rwkv6-7b", "phi3.5-moe-42b-a6.6b", "grok-1-314b",
            "jamba-1.5-large-398b", "qwen2-72b", "qwen1.5-110b",
            "gemma2-2b", "deepseek-67b", "musicgen-large", "internvl2-76b")


def is_lm_arch(arch: str) -> bool:
    base = arch[:-len(LM_SMOKE_SUFFIX)] if arch.endswith(LM_SMOKE_SUFFIX) \
        else arch
    return base in LM_ARCHS


def _lm_inventory(arch: str):
    """Zero-arg LayerShape inventory builder for an LM plan arch; imports
    the config registry lazily so planning stays import-light."""
    def build() -> List[LayerShape]:
        from ..configs.registry import get_config, get_smoke_config
        if arch.endswith(LM_SMOKE_SUFFIX):
            return lm_layers(get_smoke_config(arch[:-len(LM_SMOKE_SUFFIX)]))
        return lm_layers(get_config(arch))
    return build


INVENTORIES = {
    "tiny-resnet": tiny_resnet_layers,
    "resnet50": resnet50_layers,
    "resnet101": resnet101_layers,
}
INVENTORIES.update({a: _lm_inventory(a) for a in LM_ARCHS})
INVENTORIES.update({a + LM_SMOKE_SUFFIX: _lm_inventory(a + LM_SMOKE_SUFFIX)
                    for a in LM_ARCHS})

# Execution patch per arch: the (bm, bn) the legalizer / auto planner snap
# to.  tiny runs (8, 8) so its reduced layers still epitomize; the full
# networks use the crossbar geometry (128 word lines x 256 bit lines).
EXEC_PATCH = {
    "tiny-resnet": (8, 8),
    "resnet50": (128, 256),
    "resnet101": (128, 256),
}


def exec_patch_for(arch: str) -> Tuple[int, int]:
    """Per-arch execution patch.  LM arches mirror the EpitomeSettings
    geometry: (256, 256) full scale, (32, 32) for the reduced smoke dims
    (matching configs.get_smoke_config's patch)."""
    if arch in EXEC_PATCH:
        return EXEC_PATCH[arch]
    if arch.endswith(LM_SMOKE_SUFFIX):
        return (32, 32)
    return (256, 256)


# Default candidate (m, n) shape menus for the evolution search.
SEARCH_SHAPES = {
    "tiny-resnet": [(128, 16), (96, 16), (72, 16), (64, 16), (96, 12),
                    (48, 12), (96, 8), (64, 8), (32, 8), (16, 8)],
    "resnet50": [(1024, 256), (512, 256), (2048, 256), (256, 256),
                 (1024, 128), (512, 128)],
    "resnet101": [(1024, 256), (512, 256), (2048, 256), (256, 256),
                  (1024, 128), (512, 128)],
}
LM_SEARCH_SHAPES = [(2048, 256), (1024, 256), (512, 256), (1024, 128),
                    (512, 128), (256, 256)]
LM_SMOKE_SEARCH_SHAPES = [(64, 32), (48, 32), (32, 32), (64, 16), (32, 16),
                          (16, 16)]


def search_shapes_for(arch: str) -> List[Tuple[int, int]]:
    if arch in SEARCH_SHAPES:
        return SEARCH_SHAPES[arch]
    if arch.endswith(LM_SMOKE_SUFFIX):
        return LM_SMOKE_SEARCH_SHAPES
    return LM_SEARCH_SHAPES


def inventory_for(arch: str):
    """LayerShape inventory builder for a plan's arch (fails loudly)."""
    try:
        return INVENTORIES[arch]
    except KeyError:
        raise ValueError(f"unknown plan arch {arch!r}; "
                         f"known: {sorted(INVENTORIES)}") from None


def simulator_for(arch: str) -> PimSimulator:
    """Default simulator per arch.  The full networks use the simulator
    calibrated on the paper's Table-1 anchors; tiny-resnet scales the
    crossbar down to its (8, 8) execution patch — with 128x256 crossbars
    every tiny layer fits one tile and the #XB budget never binds, so the
    search would degenerate to all-dense.  The tiny latency coefficients
    are the reference's (pim.tables.TINY_CALIBRATION)."""
    if arch == "tiny-resnet":
        return tiny_calibrated_simulator()
    if arch.endswith(LM_SMOKE_SUFFIX):
        # smoke LMs run (32, 32) execution patches; scale the crossbar to
        # match so the #XB budget binds at CPU scale (tiny-resnet rationale)
        return PimSimulator(MappingConfig(xb_rows=32, xb_cols=32))
    return default_calibrated_simulator()


# ---------------------------------------------------------------------------
# The plan artifact
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's deployment record: what runs, at which bits, how — and
    *where* (which mesh axes the epitome's m/n dims map to)."""
    name: str
    spec: Optional[EpitomeSpec]
    weight_bits: Optional[int] = None     # None -> fp weights
    mode: str = "kernel"
    snap_err: float = 0.0                 # relative epitome-area change at
                                          # legalization (0 = untouched)
    placement: Optional[LayerPlacement] = None


@dataclasses.dataclass
class EpitomePlan:
    arch: str
    layers: List[LayerPlan]
    provenance: Dict[str, Any] = dataclasses.field(default_factory=dict)
    predicted: Optional[Dict[str, float]] = None   # SimResult.summary()
    version: int = PLAN_VERSION

    # -- views --------------------------------------------------------------
    def specs(self) -> List[Optional[EpitomeSpec]]:
        return [lp.spec for lp in self.layers]

    def bits(self) -> List[Optional[int]]:
        return [lp.weight_bits for lp in self.layers]

    def uniform_mode(self) -> str:
        modes = {lp.mode for lp in self.layers}
        if len(modes) != 1:
            raise ValueError(f"plan mixes execution modes {sorted(modes)}; "
                             "the model runs one mode network-wide")
        return next(iter(modes))

    @property
    def n_epitomized(self) -> int:
        return sum(lp.spec is not None for lp in self.layers)

    @property
    def snap_err_max(self) -> float:
        return max((lp.snap_err for lp in self.layers), default=0.0)

    @property
    def snap_err_mean(self) -> float:
        if not self.layers:
            return 0.0
        return sum(lp.snap_err for lp in self.layers) / len(self.layers)

    def is_legalized(self) -> bool:
        return bool(self.provenance.get("legalized", False))

    def tuned_blocks(self) -> Dict[str, Tuple[Tuple[int, int, int], bool]]:
        """Autotuned kernel blocks from provenance (legalize --tune):
        layer name -> ((bt, bk, bn), fused_fold).  {} when the plan was
        never tuned — the record is schema-additive."""
        rec = self.provenance.get("tuned_blocks") or {}
        out: Dict[str, Tuple[Tuple[int, int, int], bool]] = {}
        for name, r in rec.items():
            out[name] = ((int(r["bt"]), int(r["bk"]), int(r["bn"])),
                         bool(r.get("fused_fold", False)))
        return out

    def layer_configs(self) -> Tuple[Tuple[str, Any], ...]:
        """The plan as a ``(name, EpLayerConfig)`` tuple — the value
        ``ModelConfig.layer_config`` consumes, so a plan drives the LM's
        per-layer {spec, weight_bits, mode} by param-tree path.  Autotuned
        block shapes in provenance ride along (EpLayerConfig.blocks), so a
        tuned plan serves with its measured-winner kernel grid.  Lazy
        imports keep the planner free of the model code."""
        from ..core.layers import EpLayerConfig
        from ..core.quant import QuantConfig
        tuned = self.tuned_blocks()
        out = []
        for lp in self.layers:
            q = None if lp.weight_bits is None else QuantConfig(
                bits=lp.weight_bits)
            blocks, fused = tuned.get(lp.name, (None, False))
            out.append((lp.name,
                        EpLayerConfig(spec=lp.spec, mode=lp.mode, quant=q,
                                      placement=lp.placement, blocks=blocks,
                                      fused_fold=fused)))
        return tuple(out)

    def placements(self) -> List[Optional[LayerPlacement]]:
        return [lp.placement for lp in self.layers]

    # -- (de)serialization --------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "arch": self.arch,
            "provenance": self.provenance,
            "predicted": self.predicted,
            "layers": [
                {"name": lp.name, "spec": _spec_to_dict(lp.spec),
                 "weight_bits": lp.weight_bits, "mode": lp.mode,
                 "snap_err": float(lp.snap_err),
                 "placement": (None if lp.placement is None
                               else lp.placement.to_dict())}
                for lp in self.layers
            ],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EpitomePlan":
        validate_plan_dict(d)
        plan = cls(
            arch=d["arch"],
            layers=[LayerPlan(r["name"], _spec_from_dict(r["spec"]),
                              r["weight_bits"], r["mode"],
                              float(r["snap_err"]),
                              (None if r["placement"] is None
                               else LayerPlacement.from_dict(r["placement"])))
                    for r in d["layers"]],
            provenance=d["provenance"],
            predicted=d["predicted"],
            version=d["version"],
        )
        inventory = inventory_for(plan.arch)()
        names = [l.name for l in inventory]
        got = [lp.name for lp in plan.layers]
        if names != got:
            raise PlanSchemaError(
                f"plan layer names drifted from the {plan.arch} inventory: "
                f"expected {names}, got {got}")
        for l, lp in zip(inventory, plan.layers):
            if lp.spec is not None and (lp.spec.M, lp.spec.N) != (l.rows, l.cols):
                raise PlanSchemaError(
                    f"plan spec for {lp.name} covers a ({lp.spec.M}, "
                    f"{lp.spec.N}) weight but the {plan.arch} inventory "
                    f"has ({l.rows}, {l.cols})")
        return plan

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "EpitomePlan":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        validate_plan_dict(self.to_dict())    # never persist a broken plan
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "EpitomePlan":
        with open(path) as f:
            return cls.from_json(f.read())


def _spec_to_dict(s: Optional[EpitomeSpec]) -> Optional[Dict[str, int]]:
    if s is None:
        return None
    return {"M": s.M, "N": s.N, "m": s.m, "n": s.n, "bm": s.bm, "bn": s.bn}


def _spec_from_dict(d: Optional[Dict[str, int]]) -> Optional[EpitomeSpec]:
    if d is None:
        return None
    return EpitomeSpec(M=int(d["M"]), N=int(d["N"]), m=int(d["m"]),
                       n=int(d["n"]), bm=int(d["bm"]), bn=int(d["bn"]))


# ---------------------------------------------------------------------------
# Schema check — saved plans fail loudly on drift
# ---------------------------------------------------------------------------
class PlanSchemaError(ValueError):
    pass


_PLAN_KEYS = {"version", "arch", "provenance", "predicted", "layers"}
_LAYER_KEYS = {"name", "spec", "weight_bits", "mode", "snap_err", "placement"}
_SPEC_KEYS = {"M", "N", "m", "n", "bm", "bn"}
_PLACEMENT_KEYS = {"row_axis", "col_axis", "scales"}
_PREDICTED_KEYS = {"latency_s", "energy_j", "edp", "xbars", "utilization"}


def validate_plan_dict(d: Any) -> None:
    """Structural schema check of a plan dict (exact keys, types, and the
    EpitomeSpec invariants).  Raises PlanSchemaError with the offending
    path, so a drifted JSON fails loudly instead of mis-building a model."""
    def fail(path: str, msg: str) -> None:
        raise PlanSchemaError(f"plan schema violation at {path}: {msg}")

    def expect_keys(obj: Any, keys: set, path: str) -> None:
        if not isinstance(obj, dict):
            fail(path, f"expected object, got {type(obj).__name__}")
        if set(obj) != keys:
            missing, extra = keys - set(obj), set(obj) - keys
            fail(path, f"missing keys {sorted(missing)}, "
                       f"unknown keys {sorted(extra)}")

    expect_keys(d, _PLAN_KEYS, "$")
    if d["version"] != PLAN_VERSION:
        fail("$.version", f"expected {PLAN_VERSION}, got {d['version']!r}")
    if d["arch"] not in INVENTORIES:
        fail("$.arch", f"unknown arch {d['arch']!r}")
    if not isinstance(d["provenance"], dict):
        fail("$.provenance", "expected object")
    if d["predicted"] is not None:
        expect_keys(d["predicted"], _PREDICTED_KEYS, "$.predicted")
        for k, v in d["predicted"].items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                fail(f"$.predicted.{k}", f"expected number, got {v!r}")
    if not isinstance(d["layers"], list) or not d["layers"]:
        fail("$.layers", "expected non-empty array")
    for i, r in enumerate(d["layers"]):
        p = f"$.layers[{i}]"
        expect_keys(r, _LAYER_KEYS, p)
        if not isinstance(r["name"], str) or not r["name"]:
            fail(f"{p}.name", f"expected non-empty string, got {r['name']!r}")
        if r["mode"] not in MODES:
            fail(f"{p}.mode", f"expected one of {MODES}, got {r['mode']!r}")
        wb = r["weight_bits"]
        if wb is not None and (not isinstance(wb, int) or isinstance(wb, bool)
                               or not 1 <= wb <= 16):
            fail(f"{p}.weight_bits", f"expected null or int in [1, 16], "
                                     f"got {wb!r}")
        se = r["snap_err"]
        if not isinstance(se, (int, float)) or isinstance(se, bool) or se < 0:
            fail(f"{p}.snap_err", f"expected number >= 0, got {se!r}")
        pl = r["placement"]
        if pl is not None:
            expect_keys(pl, _PLACEMENT_KEYS, f"{p}.placement")
            for ax in ("row_axis", "col_axis"):
                v = pl[ax]
                if v is not None and v not in MESH_AXES:
                    fail(f"{p}.placement.{ax}",
                         f"expected null or one of {MESH_AXES}, got {v!r}")
            if pl["row_axis"] is not None \
                    and pl["row_axis"] == pl["col_axis"]:
                fail(f"{p}.placement",
                     f"row_axis and col_axis are both {pl['row_axis']!r}; "
                     "a mesh axis can shard only one dim")
            if pl["scales"] not in SCALE_MODES:
                fail(f"{p}.placement.scales",
                     f"expected one of {SCALE_MODES}, got {pl['scales']!r}")
        s = r["spec"]
        if s is None:
            continue
        # an epitomized kernel-mode layer with no placement record cannot be
        # laid out by the mesh/prepack consumers — fail at the schema, not
        # deep inside serving
        if r["mode"] == "kernel" and pl is None:
            fail(f"{p}.placement",
                 "kernel-mode epitomized layers require a placement record")
        expect_keys(s, _SPEC_KEYS, f"{p}.spec")
        for k, v in s.items():
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                fail(f"{p}.spec.{k}", f"expected positive int, got {v!r}")
        if not (s["m"] <= s["M"] and s["n"] <= s["N"]
                and s["bm"] <= s["m"] and s["bn"] <= s["n"]):
            fail(f"{p}.spec", f"violates bm <= m <= M / bn <= n <= N: {s}")


# ---------------------------------------------------------------------------
# Kernel-exact (bn-aligned) spec families + legalization
# ---------------------------------------------------------------------------
def is_kernel_exact(spec: EpitomeSpec) -> bool:
    """The fused kernels' OFAT col-block table samples exactly the same W
    as ``reconstruct`` iff every column offset is bn-aligned (row offsets
    are always free: fold_rows is exact for any row map)."""
    return bool((spec.col_offsets() % spec.bn == 0).all())


def _aligned_candidates(M: int, N: int, area: float,
                        patch: Tuple[int, int]) -> Iterator[EpitomeSpec]:
    """Kernel-exact specs for an (M, N) layer near a target epitome area:
    column designs restricted to wrap (n == bn) / identity (n == N) and row
    counts near area/n (bm multiples plus the exact value)."""
    bm0, bn0 = patch
    bm, bn = min(bm0, M), min(bn0, N)
    n_cands = {bn} | ({N} if N % bn == 0 else set())
    for n in sorted(n_cands):
        m_t = area / n
        for m in {max(bm, int(m_t) // bm * bm),
                  max(bm, -(-int(m_t) // bm) * bm),
                  max(bm, int(round(m_t))),
                  M}:
            m = min(m, M)
            if m * n >= M * N:          # not actually smaller -> not a spec
                continue
            yield EpitomeSpec(M=M, N=N, m=m, n=n, bm=bm, bn=bn)


def legalize_spec(layer: LayerShape, spec: Optional[EpitomeSpec],
                  patch: Tuple[int, int]
                  ) -> Tuple[Optional[EpitomeSpec], float]:
    """Snap one searched spec to the nearest kernel-exact family at the
    execution patch.  Returns (legal spec, relative epitome-area change).
    Dense stays dense; a layer with no legal compressed family goes dense
    with the area growth reported as its snap error."""
    if spec is None:
        return None, 0.0
    M, N = layer.rows, layer.cols
    area = spec.m * spec.n
    best, best_err = None, math.inf
    for cand in _aligned_candidates(M, N, area, patch):
        err = abs(cand.m * cand.n - area) / area
        if err < best_err:
            best, best_err = cand, err
    if best is None:
        return None, abs(M * N - area) / area
    assert is_kernel_exact(best), best
    return best, best_err


def pack_grid(spec: EpitomeSpec, tile: int = 256) -> Tuple[int, int]:
    """(ceil(m/bk), n/bn) shape of a packed epitome's Es/Ez scale grids.

    A mirror of ``kernels.ops.pack_blocks`` that needs no kernel module
    (``tile`` is the quantizer's crossbar tile, QuantConfig.tile — the
    plan pipeline always
    builds QuantConfigs at the 256 default) — the planner must know the
    grid shape to snap ``scales='shard'`` placements without importing the
    kernel stack; a cross-check test guards against drift.  Mirrors
    ``_pick_bk_quant``'s prime/odd-m fallback: the largest standard block
    not exceeding min(tile, m) when nothing divides m exactly."""
    blocks = (256, 128, 64, 32, 16, 8)
    bk = next((b for b in blocks if b <= tile and spec.m % b == 0), None)
    if bk is None:
        bk = next((b for b in blocks if b <= min(tile, spec.m)), spec.m)
    return -(-spec.m // bk), -(-spec.n // spec.bn)


def legalize_placements(plan: EpitomePlan,
                        mesh_shape: Dict[str, int]
                        ) -> Tuple[EpitomePlan, Dict[str, List[str]]]:
    """Placement half of the legalization pass: snap every layer's
    annotation to the divisibility constraints of its (legalized) spec on a
    concrete mesh — m/n must tile evenly over the assigned axis — dropping
    offending axes to replicated.  Returns the snapped plan plus the
    per-layer fallback report (also stamped into provenance so the
    artifact records what degraded and why)."""
    layers = inventory_for(plan.arch)()
    out: List[LayerPlan] = []
    report: Dict[str, List[str]] = {}
    for l, lp in zip(layers, plan.layers):
        rows, cols = ((lp.spec.m, lp.spec.n) if lp.spec is not None
                      else (l.rows, l.cols))
        grid = (pack_grid(lp.spec)
                if lp.spec is not None and lp.weight_bits is not None
                else None)
        snapped, fallbacks = snap_placement(lp.placement, rows, cols,
                                            dict(mesh_shape),
                                            scale_grid=grid)
        if fallbacks:
            report[lp.name] = fallbacks
        out.append(dataclasses.replace(lp, placement=snapped))
    snapped_plan = dataclasses.replace(
        plan, layers=out,
        provenance={**plan.provenance,
                    "mesh_shape": {k: int(v) for k, v in mesh_shape.items()},
                    "placement_fallbacks": report})
    return snapped_plan, report


def legalize_plan(plan: EpitomePlan, *,
                  patch: Optional[Tuple[int, int]] = None,
                  simulator: Optional[PimSimulator] = None,
                  wrapping: bool = True,
                  mesh_shape: Optional[Dict[str, int]] = None,
                  cost: Optional[CostModel] = None) -> EpitomePlan:
    """The legalization pass: every spec snaps to a kernel-exact family,
    per-layer snap errors are recorded, and the cost is re-simulated so the
    plan's prediction describes the design that will actually run.  Layers
    missing a placement gain the role-based default; with ``mesh_shape``
    (axis name -> size) the placements are additionally snapped to the
    divisibility constraints of the legalized specs (reported fallbacks in
    provenance).  ``provenance['cost']`` records the per-layer cost under
    ``cost`` (default: the analytic simulator; pass a ``MeasuredCost`` to
    record measured kernel latency next to the analytic numbers)."""
    layers = inventory_for(plan.arch)()
    patch = tuple(patch or exec_patch_for(plan.arch))
    out: List[LayerPlan] = []
    for l, lp in zip(layers, plan.layers):
        legal, err = legalize_spec(l, lp.spec, patch)
        placement = lp.placement or default_placement(l.name)
        out.append(dataclasses.replace(lp, spec=legal, snap_err=err,
                                       placement=placement))
    legal_plan = EpitomePlan(
        arch=plan.arch, layers=out,
        provenance={**plan.provenance, "legalized": True,
                    "patch": list(patch)})
    if mesh_shape is not None:
        legal_plan, _ = legalize_placements(legal_plan, mesh_shape)
    sim = simulator or simulator_for(plan.arch)
    legal_plan.predicted = sim.simulate_plan(
        legal_plan, wrapping=wrapping,
        act_bits=plan.provenance.get("act_bits")).summary()
    _stamp_cost(legal_plan, cost or AnalyticCost(sim))
    return legal_plan


# ---------------------------------------------------------------------------
# Planners — every design path emits an EpitomePlan
# ---------------------------------------------------------------------------
def _stamp_cost(plan: EpitomePlan, cost: CostModel) -> EpitomePlan:
    """Record a plan's per-layer cost under ``cost`` into
    ``provenance['cost']`` (schema-additive: provenance is free-form).
    Under ``AnalyticCost`` the record's ``measured_s`` fields are null;
    under ``MeasuredCost`` both columns are real numbers — the artifact
    always shows predicted and (when available) measured side by side."""
    plan.provenance["cost_model"] = cost.name
    plan.provenance["cost"] = cost.plan_cost(plan).record()
    return plan

def plan_conv_specs(layers: Sequence[LayerShape], target_cr: float = 2.0,
                    patch: Tuple[int, int] = (8, 8)
                    ) -> List[Optional[EpitomeSpec]]:
    """Kernel-exact epitome specs for a LayerShape inventory (ex
    models.resnet; the spec-level designer under ``auto_plan``).

    Column designs are restricted to the bn-aligned families — wrap
    (n == bn, every output block samples epitome block 0) or identity
    (n == N, distinct aligned blocks) — so the kernel modes' OFAT
    col-block table samples exactly the same W as ``reconstruct``; row
    offsets stay unrestricted because fold_rows is exact for any row map.
    Layers too small to compress stay dense (None), mirroring the paper
    keeping small ResNet layers un-epitomized."""
    specs: List[Optional[EpitomeSpec]] = []
    for l in layers:
        budget = l.rows * l.cols / target_cr
        best, best_err = None, math.inf
        for s in _aligned_candidates(l.rows, l.cols, budget, patch):
            err = abs(s.compression_rate - target_cr) / target_cr
            if err < best_err:
                best, best_err = s, err
        specs.append(best)
    return specs


def plan_from_specs(arch: str, specs: Sequence[Optional[EpitomeSpec]], *,
                    weight_bits: Optional[int] = None, mode: str = "kernel",
                    planner: str = "manual",
                    simulator: Optional[PimSimulator] = None,
                    act_bits: Optional[int] = None, wrapping: bool = True,
                    provenance: Optional[Dict[str, Any]] = None,
                    placements: Optional[Sequence[Optional[LayerPlacement]]]
                    = None,
                    cost: Optional[CostModel] = None) -> EpitomePlan:
    """Wrap a bare spec list into a plan: provenance + simulated cost.
    Placement defaults to the role-based serving layout per layer.
    ``provenance['cost']`` records per-layer analytic (and, with a
    ``MeasuredCost``, measured) latency."""
    layers = inventory_for(arch)()
    if len(specs) != len(layers):
        raise ValueError(f"{len(specs)} specs for {len(layers)} layers")
    if placements is None:
        placements = [default_placement(l.name) for l in layers]
    elif len(placements) != len(layers):
        raise ValueError(f"{len(placements)} placements for "
                         f"{len(layers)} layers")
    plan = EpitomePlan(
        arch=arch,
        layers=[LayerPlan(l.name, s, weight_bits, mode, placement=pl)
                for l, s, pl in zip(layers, specs, placements)],
        provenance={"planner": planner, "act_bits": act_bits,
                    "legalized": False, **(provenance or {})})
    sim = simulator or simulator_for(arch)
    plan.predicted = sim.simulate_plan(plan, wrapping=wrapping,
                                       act_bits=act_bits).summary()
    return _stamp_cost(plan, cost or AnalyticCost(sim))


def uniform_plan(arch: str, m: int = 1024, n: int = 256, *,
                 weight_bits: Optional[int] = None, mode: str = "kernel",
                 simulator: Optional[PimSimulator] = None,
                 act_bits: Optional[int] = None) -> EpitomePlan:
    """The paper's uniform design (e.g. "1024x256") as a plan."""
    sim = simulator or simulator_for(arch)
    specs = uniform_epitome_specs(inventory_for(arch)(), m, n, sim.mapping)
    return plan_from_specs(arch, specs, weight_bits=weight_bits, mode=mode,
                           planner="uniform_epitome_specs", simulator=sim,
                           act_bits=act_bits,
                           provenance={"uniform_shape": [m, n]})


def auto_plan(arch: str, target_cr: float = 2.0, *,
              patch: Optional[Tuple[int, int]] = None,
              weight_bits: Optional[int] = None, mode: str = "kernel",
              simulator: Optional[PimSimulator] = None,
              act_bits: Optional[int] = None) -> EpitomePlan:
    """CR-targeted kernel-exact design (what tiny_resnet specs='auto' and
    the registry variants run) as a plan.  Born legal: snap error 0."""
    patch = tuple(patch or exec_patch_for(arch))
    specs = plan_conv_specs(inventory_for(arch)(), target_cr=target_cr,
                            patch=patch)
    plan = plan_from_specs(arch, specs, weight_bits=weight_bits, mode=mode,
                           planner="plan_conv_specs", simulator=simulator,
                           act_bits=act_bits,
                           provenance={"target_cr": target_cr,
                                       "patch": list(patch),
                                       "legalized": True})
    return plan


def search_plan(arch: str, *, objective: str = "latency",
                weight_bits: Optional[int] = None,
                act_bits: Optional[int] = None,
                shapes: Optional[Sequence[Tuple[int, int]]] = None,
                budget_xbars: Optional[int] = None,
                evo: Optional[EvoConfig] = None, mode: str = "kernel",
                simulator: Optional[PimSimulator] = None,
                seed_plan: Optional[EpitomePlan] = None,
                cost: Optional[CostModel] = None,
                measure_top_k: int = 4) -> EpitomePlan:
    """Algorithm-1 evolution search, emitted as a plan.

    Seeds {P}_0 with ``seed_plan`` (default: the auto_plan design, which
    also sets the crossbar budget so the search optimizes cost at matched
    area).  The searched specs are generally NOT kernel-exact — run the
    result through ``legalize_plan`` before executing it.

    ``cost`` (a ``MeasuredCost``) switches on hardware-in-the-loop mode:
    each generation's elite front (top ``measure_top_k`` feasible designs)
    is re-ranked by measured kernel latency, the winner is the
    measured-best elite across generations, and provenance additionally
    records ``cost_model``, the per-generation ``measured_elites`` log, and
    the winning plan's per-layer analytic+measured ``cost``."""
    layers = inventory_for(arch)()
    sim = simulator or simulator_for(arch)
    cfg = dataclasses.replace(evo or EvoConfig(), objective=objective)
    shapes = list(shapes or search_shapes_for(arch))
    cands = [candidate_specs(l, sim.mapping, shapes) for l in layers]

    if seed_plan is None:
        seed_specs = plan_conv_specs(layers, patch=exec_patch_for(arch))
    else:
        if seed_plan.arch != arch:
            raise ValueError(f"seed plan is for {seed_plan.arch}, not {arch}")
        seed_specs = seed_plan.specs()
    # the gene space must be able to express the seed design exactly
    for i, s in enumerate(seed_specs):
        if s is not None and s not in cands[i]:
            cands[i].append(s)

    wb = None if weight_bits is None else [weight_bits] * len(layers)
    if budget_xbars is None:
        budget_xbars = count_crossbars(layers, sim.mapping, seed_specs, wb)
    elite_log: Optional[List[Dict[str, Any]]] = \
        [] if cost is not None else None
    best, simres, curve = evolution_search(
        layers, cands, sim, budget_xbars, cfg, weight_bits=wb,
        seeds=[seed_specs], act_bits=act_bits, cost=cost,
        measure_top_k=measure_top_k, elite_log=elite_log)
    provenance = {"planner": "evolution_search", "objective": cfg.objective,
                  "seed": cfg.seed, "population": cfg.population,
                  "iterations": cfg.iterations,
                  "budget_xbars": int(budget_xbars),
                  "act_bits": act_bits, "shapes": [list(s) for s in shapes],
                  "best_curve": [float(r) for r in curve],
                  "legalized": False}
    if cost is not None:
        provenance["cost_model"] = cost.name
        provenance["measured_elites"] = elite_log
    plan = EpitomePlan(
        arch=arch,
        layers=[LayerPlan(l.name, s, weight_bits, mode,
                          placement=default_placement(l.name))
                for l, s in zip(layers, best)],
        provenance=provenance,
        predicted=simres.summary())
    if cost is not None:
        _stamp_cost(plan, cost)
    return plan
