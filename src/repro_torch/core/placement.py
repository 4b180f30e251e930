"""Layer placement: which mesh axes an epitome's (m, n) dims live on.

A PIM deployment does not stop at choosing per-layer epitome shapes — the
packed crossbar contents still have to be *placed* across many arrays /
chips, exactly the mapping/partitioning step PIM compilers (PIMCOMP) and
synthesis flows (PIMSYN) treat as first-class.  ``LayerPlacement`` is the
schema-checked record of that decision for one layer:

  * ``row_axis``  — mesh axis the epitome's m (fan-in / word-line) dim is
    sharded over, or None (replicated).  Row sharding splits the matmul
    contraction, so partial sums are combined across devices in a
    device-dependent order: it buys capacity but is NOT bit-exact vs the
    single-device path.  The role-based defaults therefore never set it.
  * ``col_axis``  — mesh axis the n (fan-out / bit-line) dim is sharded
    over, or None.  Column sharding only concatenates independent output
    columns; it is bit-exact, and is the default serving layout.
  * ``scales``    — 'replicate' | 'shard' for the per-crossbar-tile
    (Es, Ez) scale/zero grids of a packed int8 epitome; 'shard' lays the
    tile grid out like the codes, 'replicate' (default) keeps the tiny
    grids everywhere.

A copy of ``repro.core.placement``, so plans round-trip between the two
packages.  pim/plan.py (the planner side) and core/layers.py (the
execution side) both import it.  On one card a placement is carried in
the plan and the layer configs, not applied: sharding by placement comes
with the scale-out slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

# The logical mesh axes of a serving mesh (batch -> ('pod', 'data'),
# tensor -> 'model').
MESH_AXES = ("pod", "data", "model")
SCALE_MODES = ("replicate", "shard")


@dataclasses.dataclass(frozen=True)
class LayerPlacement:
    """Where one layer's epitome (or dense weight) lives on the mesh."""
    row_axis: Optional[str] = None        # m / fan-in dim (None = replicate)
    col_axis: Optional[str] = "model"     # n / fan-out dim
    scales: str = "replicate"             # (Es, Ez) tile grids

    def __post_init__(self):
        for ax in (self.row_axis, self.col_axis):
            if ax is not None and ax not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {ax!r}; "
                                 f"known: {MESH_AXES}")
        if self.row_axis is not None and self.row_axis == self.col_axis:
            # a sharding cannot use one axis for two dims — fail here, not
            # deep inside serving
            raise ValueError(f"row_axis and col_axis are both "
                             f"{self.row_axis!r}; a mesh axis can shard "
                             f"only one dim")
        if self.scales not in SCALE_MODES:
            raise ValueError(f"scales must be one of {SCALE_MODES}, "
                             f"got {self.scales!r}")

    def to_dict(self) -> Dict[str, Any]:
        return {"row_axis": self.row_axis, "col_axis": self.col_axis,
                "scales": self.scales}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LayerPlacement":
        return cls(row_axis=d["row_axis"], col_axis=d["col_axis"],
                   scales=d["scales"])


# ---------------------------------------------------------------------------
# Role-based defaults, derived from the inventory naming contract
# ---------------------------------------------------------------------------
# pim.workloads.lm_layers names every projection by its param-tree path
# ("L0/mixer/wq", "L0/ffn/w_down", ...).  The trailing component tells the
# role; rows of the fan-out role carry d_model, rows of the fan-in role
# carry the large d_ff / heads dim.
_FAN_OUT = ("wq", "wk", "wv", "wg", "wr", "in_proj", "x_proj", "dt_proj",
            "w_gate", "w_up")
_FAN_IN = ("wo", "out_proj", "w_down")


def placement_role(name: str) -> str:
    """'fan_out' | 'fan_in' for an inventory layer name.

    The rwkv channel-mix reuses mixer names under /ffn/: there wk is
    (d, ff) fan-out but wv is (ff, d) fan-in.  Conv / fc inventory names (ResNet) are fan-out: rows are the
    im2col fan-in, cols the output channels."""
    last = name.rsplit("/", 1)[-1].rsplit(".", 1)[-1]
    if "/ffn/" in name and last == "wv":
        return "fan_in"
    if last in _FAN_IN:
        return "fan_in"
    return "fan_out"


def default_placement(name: str) -> LayerPlacement:
    """The serving default: bit-exact column-parallel layout.

    Fan-out sites put their large output dim (d_ff, heads) on 'model' —
    classic Megatron column parallelism.  Fan-in sites project back to
    d_model; their output goes on 'data' so the two roles spread storage
    over both mesh axes.  Rows (the matmul contraction) stay replicated:
    sharding them reorders the partial-sum accumulation and the sharded
    logits would no longer be bit-identical to the single-device path —
    plans may still opt in per layer for capacity."""
    col = "data" if placement_role(name) == "fan_in" else "model"
    return LayerPlacement(row_axis=None, col_axis=col, scales="replicate")


def snap_placement(placement: Optional[LayerPlacement],
                   rows: int, cols: int,
                   mesh_shape: Dict[str, int],
                   scale_grid: Optional[tuple] = None):
    """Snap one placement to the divisibility constraints of a mesh.

    An axis annotation survives only if the assigned dim tiles evenly over
    the axis size (and the axis exists in the mesh); otherwise it falls
    back to replicated.  With ``scale_grid`` (the (m/bk, n/bn) shape of a
    packed layer's Es/Ez tile grids), ``scales='shard'`` additionally
    requires the surviving axes to divide the grid dims — else the scale
    tiles fall back to replicated too, so the artifact records the layout
    that will actually run.  Returns (snapped placement, list of
    human-readable fallback reasons) — the reported-fallback contract of
    the placement legalization pass."""
    if placement is None:
        return None, []
    fallbacks = []
    fixed = {}
    for field, dim in (("row_axis", rows), ("col_axis", cols)):
        ax = getattr(placement, field)
        fixed[field] = ax
        if ax is None:
            continue
        size = mesh_shape.get(ax)
        if size is None:
            fallbacks.append(f"{field}={ax!r} absent from mesh "
                             f"{dict(mesh_shape)}; replicated")
            fixed[field] = None
        elif dim % size != 0:
            fallbacks.append(f"{field}={ax!r}: dim {dim} % {size} != 0; "
                             f"replicated")
            fixed[field] = None
    scales = placement.scales
    if scales == "shard" and scale_grid is not None:
        for field, gdim in (("row_axis", scale_grid[0]),
                            ("col_axis", scale_grid[1])):
            ax = fixed[field]
            if ax is None:
                continue
            size = mesh_shape[ax]       # survived the checks above
            if gdim % size != 0:
                fallbacks.append(
                    f"scales='shard': grid dim {gdim} % {size} != 0 on "
                    f"{field}={ax!r}; scale tiles replicated")
                scales = "replicate"
                break
    snapped = dataclasses.replace(placement, scales=scales, **fixed)
    return snapped, fallbacks
