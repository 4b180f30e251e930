"""Roofline of a dry-run cell (counterpart of ``repro.launch.roofline``).

Three terms per (arch x shape x mesh), all in seconds, on a card's
data-sheet constants (``Chip``; H100 SXM5 by default):

    compute    = FLOPs a rank / peak bf16 FLOP/s
    memory     = the analytic must-hit-HBM bytes a rank / HBM B/s
    collective = sum over the mesh axes of a rank's collective bytes on
                 that axis / that axis's link B/s

The FLOPs are what the dry run's trace counted (``launch.dryrun``:
``FlopCounterMode`` over the step's aten ops, plus each kernel's operations
from ``kernels.cost``); the XLA-style per-op bytes (every op's inputs and
outputs) are kept beside the analytic term as ``t_memory_xla_bound_s``, as
the reference keeps its ``bytes accessed``.

Collective bytes (a deliberate, stated simplification, as the reference's
is): the reference parses its compiled HLO; the port has none, so
``CollectiveCounter`` sums the output bytes of every ``torch.ops.c10d``
op a traced step runs (the gathered tensor of an
all_gather, the reduced block of a reduce_scatter, the reduced tensor of
an all_reduce, the received buffer of an all_to_all), by op and by the
mesh axis of its process group, with the reference's ring multipliers
(``_VOLUME_MULT``: an all-reduce moves about twice its operand).  Each
axis is charged over its own link: 'model', inside an HGX node, over one
direction of NVLink 4 (``NVLINK_BW / 2``); 'data' and 'pod' (and the two
flattened, the MoE dispatch's group) over the card's InfiniBand adapter
(``IB_BW``); the axes' times add, overlapping nothing.

Two yardsticks of useful work.  ``model_flops`` is the reference's
MODEL_FLOPS = 6 N(active) D with N its ``param_count``: every weight at
its dense, virtual size, the RWKV channel mix left out.  An epitome
config multiplies by its epitomes, not by the dense weights they stand
for, so against its counted FLOPs that yardstick reads above 1 (phase 18
of ``chip_smoke.py`` read 1.011 for rwkv6-7b's ``folded-q3`` training
step and 1.493 / 1.319 for its ``kernel-q3`` prefill / decode step).  It
is kept, as ``model_flops``, for parity with the reference.  The shares
(``useful_ratio``, ``ideal_s``, ``roofline_fraction``; the ``benchmark``
PR's MFU) read ``useful_flops`` instead: 6 N D with N the weights of the
step's matrix products at the size each product multiplies
(``product_params``), the least product work of the step's function, so
no counted step can fall below it (about 0.75 of a training step: the
remat recomputes the forward).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..kernels.cost import BF16_TC_FLOPS, HBM_BW, IB_BW, NVLINK_BW
from ..models.config import LayerKind

# effective payload multiplier per op (ring algorithms)
_VOLUME_MULT = {
    "all-reduce": 2.0,         # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


# the reference's op names of the c10d collectives a step runs
_C10D_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}


def _group_axes(mesh) -> Dict[str, str]:
    """{process group name: the mesh axis it runs over}; the batch axes'
    flattened group (the MoE dispatch's) by their joined name."""
    import torch.distributed as dist
    from ..models.moe import batch_group
    axes = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    batch = [a for a in ("pod", "data") if a in mesh.mesh_dim_names]
    if len(batch) > 1:
        axes[batch_group(mesh).group_name] = "_".join(batch)
    axes.setdefault(dist.group.WORLD.group_name, "world")
    return axes


class CollectiveCounter:
    """The counterpart of the reference's ``collective_bytes(hlo_text)``:
    the output bytes of every ``torch.ops.c10d`` collective it observes
    (its first argument, the tensors it writes), by op and by the mesh axis
    of its process group.  The dry run's ``StepCounter`` hands it each c10d
    op a traced step dispatches.  ``result()`` has the reference's keys
    plus ``bytes_by_axis`` ({axis: {op: bytes}}) and ``weighted_by_axis``."""

    def __init__(self, mesh):
        self.axes = _group_axes(mesh)
        self.by_axis: Dict[str, Dict[str, float]] = {}
        self.count: Dict[str, int] = {}

    def observe(self, func, args) -> None:
        """Count one dispatched op if it is a collective (``_C10D_OPS``)."""
        op = _C10D_OPS.get(func._opname)
        if op is None:
            return
        import torch.distributed as dist
        group = next(a for a in args if isinstance(a, torch.ScriptObject)
                     and "ProcessGroup" in str(a._type()))
        axis = self.axes.get(dist.ProcessGroup.unbox(group).group_name, "other")
        nbytes = sum(t.numel() * t.element_size()
                     for t in torch.utils._pytree.tree_leaves(args[0])
                     if isinstance(t, torch.Tensor))
        per = self.by_axis.setdefault(axis, {})
        per[op] = per.get(op, 0.0) + nbytes
        self.count[op] = self.count.get(op, 0) + 1

    def result(self) -> Dict[str, Any]:
        by_op: Dict[str, float] = {}
        for per in self.by_axis.values():
            for op, b in per.items():
                by_op[op] = by_op.get(op, 0.0) + b
        weighted = {a: sum(_VOLUME_MULT[op] * b for op, b in per.items())
                    for a, per in self.by_axis.items()}
        return {"bytes_by_op": by_op, "count_by_op": dict(self.count),
                "raw_bytes": sum(by_op.values()), "weighted_bytes": sum(weighted.values()),
                "bytes_by_axis": {a: dict(p) for a, p in self.by_axis.items()},
                "weighted_by_axis": weighted}


@dataclasses.dataclass(frozen=True)
class Chip:
    """A card's data-sheet constants: bf16 FLOP/s, HBM B/s, and the B/s a
    rank's collectives on each mesh axis run at (``link_bw``; ``default_bw``
    for an axis not listed)."""
    peak_flops: float
    hbm_bw: float
    link_bw: Dict[str, float]
    default_bw: float

    def axis_bw(self, axis: str) -> float:
        return self.link_bw.get(axis, self.default_bw)


# an NVIDIA H100 SXM5's data sheet; 'model' inside an NVLink node, the batch
# axes over its InfiniBand adapter (launch.mesh.make_production_mesh)
H100 = Chip(BF16_TC_FLOPS, HBM_BW,
            {"model": NVLINK_BW / 2, "data": IB_BW, "pod": IB_BW, "pod_data": IB_BW}, IB_BW)


def analytic_hbm_bytes(cfg, cell, n_chips: int, grad_accum: int = 1,
                       minimal: bool = False) -> float:
    """First-principles HBM traffic per chip per step, the reference's
    model arithmetic for arithmetic:

    train:   params bf16 read 3x (fwd + bwd + remat re-read) + gradient
             write/read + optimizer state read/write (fp32 m,v,master or
             int8) + remat-boundary activations (save+reload) + fp32 logits
             (write + softmax read + grad) per microbatch.
    prefill: params once + boundary activations + KV-cache write.
    decode:  params once + full KV/state read + tiny token traffic.

    Epitome configs shrink the *parameter* terms by the compression rate;
    ``minimal`` is the best achievable traffic (the roofline's "ideal")."""
    P = cfg.param_count()                       # total params
    cr = cfg.epitome.target_cr if cfg.epitome.enabled else 1.0
    # per-mode weight-traffic multiplier on the compressible fraction
    mode_mult = {"reconstruct": 1.0 / cr + 2.0, "wrapped": 1.0 / cr + 1.0,
                 "folded": 1.0 / cr, "kernel": 1.0 / cr}
    mult = mode_mult.get(cfg.epitome.mode, 1.0) if cfg.epitome.enabled else 1.0
    if minimal:
        mult = 1.0 / cr if cfg.epitome.enabled else 1.0
    # embedding/head are never epitomized
    embed_p = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    P_eff = embed_p + (P - embed_p) * mult
    B, S = cell.global_batch, cell.seq_len
    d, V, G = cfg.d_model, cfg.vocab, cfg.n_groups
    L_per_group = len(cfg.pattern)
    if cell.kind == "train":
        micro = max(1, B // grad_accum)
        param_t = (3 * 2 * P_eff) * grad_accum \
            + 2 * 4 * P_eff + 2 * 4 * P_eff + 4 * 4 * P_eff
        act_t = grad_accum * (
            2 * 2 * G * L_per_group * micro * S * d
            + 3 * 4 * micro * S * V)
        return (param_t + act_t) / n_chips
    if cell.kind == "prefill":
        act_t = 2 * 2 * G * L_per_group * B * S * d
        cache_t = 2 * 2 * cfg.n_kv_heads * cfg.hd * B * S * _n_attn(cfg)
        return (2 * P_eff + act_t + cache_t) / n_chips
    # decode: read all weights + full state per token
    cache_t = _state_bytes(cfg, B, S)
    return (2 * P_eff + cache_t) / n_chips


def _n_attn(cfg) -> int:
    per = sum(1 for k in cfg.pattern
              if k in (LayerKind.ATTN.value, LayerKind.ATTN_LOCAL.value))
    return per * cfg.n_groups


def _state_bytes(cfg, B: int, S: int) -> float:
    kv_bytes = cfg.kv_cache_bits / 8.0
    if cfg.kv_cache_bits == 8:
        kv_bytes += 2.0 / cfg.hd          # per-(token, head) fp16 scale
    total = 0.0
    for kind in cfg.pattern:
        if kind in (LayerKind.ATTN.value, LayerKind.ATTN_LOCAL.value):
            Seff = min(S, cfg.window) if kind == LayerKind.ATTN_LOCAL.value else S
            total += 2 * kv_bytes * B * Seff * cfg.n_kv_heads * cfg.hd
        elif kind == LayerKind.MAMBA.value:
            total += 4 * B * cfg.mamba_d_inner * cfg.mamba_d_state
        elif kind == LayerKind.RWKV.value:
            K = cfg.d_model // cfg.n_heads
            total += 4 * B * cfg.n_heads * K * K
    return total * cfg.n_groups


def model_flops(cfg, cell) -> float:
    """6*N*D with N = active params (MoE: top-k experts only); 2*N*D for a
    prefill, 2*N a row for a decode step: the reference's yardstick, N its
    dense ``param_count`` (see the module doc)."""
    return _six_n_d(cfg.param_count(active_only=True), cell)


def useful_flops(cfg, cell) -> float:
    """``model_flops``'s form with N = ``product_params(cfg)``: the least
    product work of the step's function, the yardstick of its shares.  A
    prefill returns each row's last logits only, so its head (d * vocab)
    multiplies one token a row."""
    n = product_params(cfg, active_only=True)
    if cell.kind == "prefill":
        head = cfg.d_model * cfg.vocab
        return 2.0 * (n - head) * cell.global_batch * cell.seq_len \
            + 2.0 * head * cell.global_batch
    return _six_n_d(n, cell)


def _six_n_d(n: float, cell) -> float:
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * cell.global_batch      # decode: one token


def product_params(cfg, active_only: bool = False) -> int:
    """The weights of a forward's matrix products, each at the size its
    product multiplies: a projection site (``lm.lm_layer_configs``) at its
    epitome (m * n) where it is epitomized, else at (M * N); the RWKV
    mixer's LoRAs; an MoE layer's router and its experts (the top k when
    ``active_only``); the head (d * vocab, the embedding's table when tied).
    Lookups, norms, token-shift mixes, convolutions and the recurrences
    count nothing.  An epitome mode that multiplies more (``paper``
    rebuilds the dense weight, ``wrapped`` its unique column blocks, the
    kernels whole column blocks) does more than this, never less."""
    from ..models.lm import lm_layer_configs
    from ..pim.workloads import lm_layers
    lcs = lm_layer_configs(cfg)
    n = 0
    for site in lm_layers(cfg):
        spec = lcs[site.name].spec
        n += spec.m * spec.n if spec is not None else site.rows * site.cols
    d, ff = cfg.d_model, cfg.d_ff
    for kind, ffn in cfg.full_pattern:
        if kind == LayerKind.RWKV.value:
            n += d * cfg.rwkv_lora_decay * 2 + 5 * d * cfg.rwkv_lora_mix * 2
        if ffn == "moe":
            e = cfg.top_k if active_only else cfg.n_experts
            n += e * 3 * d * ff + d * cfg.n_experts
    return n * cfg.n_groups + d * cfg.vocab


def collective_seconds(coll: Dict[str, Any], chip: Chip) -> float:
    """Each axis's weighted collective bytes over its link, summed.  A
    ``coll`` without ``weighted_by_axis`` (the reference's) is charged
    whole at the chip's default link."""
    by_axis = coll.get("weighted_by_axis")
    if by_axis is None:
        return coll["weighted_bytes"] / chip.default_bw
    return sum(b / chip.axis_bw(axis) for axis, b in by_axis.items())


def roofline_terms(cost: Dict[str, float], coll: Dict[str, Any],
                   cfg, cell, n_chips: Optional[int] = None,
                   grad_accum: int = 1, chip: Chip = H100) -> Dict[str, float]:
    """The three terms, the dominant one and the bound; with ``cfg`` and
    ``cell``, the reference's MODEL_FLOPS and the port's ``useful_flops``,
    the useful share of the counted FLOPs and the ideal step (the useful
    FLOPs at peak, or the minimal HBM traffic) over the bound, both shares
    read against ``useful_flops`` (the module doc says why).  ``cost``:
    {"flops", "bytes accessed"} a rank."""
    n_chips = n_chips or 256
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    t_compute = flops_dev / chip.peak_flops
    # two memory estimates: the per-op bound (every op's operands) and the
    # analytic must-hit-HBM model; the dominant/fraction figures use the
    # analytic term, the per-op bound is recorded alongside
    t_mem_xla = bytes_dev / chip.hbm_bw
    t_memory = t_mem_xla
    if cfg is not None and cell is not None:
        hbm = analytic_hbm_bytes(cfg, cell, n_chips, grad_accum)
        t_memory = hbm / chip.hbm_bw
    t_coll = collective_seconds(coll, chip)
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_xla_bound_s": t_mem_xla,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }
    if cfg is not None and cell is not None:
        mf = useful_flops(cfg, cell)
        total = flops_dev * n_chips
        out["model_flops"] = model_flops(cfg, cell)
        out["useful_flops"] = mf
        out["useful_ratio"] = mf / total if total > 0 else 0.0
        ideal_c = mf / (n_chips * chip.peak_flops)
        ideal_m = analytic_hbm_bytes(cfg, cell, n_chips, grad_accum,
                                     minimal=True) / chip.hbm_bw
        out["ideal_compute_s"] = ideal_c
        out["ideal_s"] = max(ideal_c, ideal_m)
        out["roofline_fraction"] = (out["ideal_s"] / out["bound_s"]
                                    if out["bound_s"] > 0 else 0.0)
    return out


def format_row(r: Dict[str, Any]) -> str:
    rl = r["roofline"]
    return (f"| {r['arch']} | {r['shape']} | {r['epitome']} | {r['mesh']} | "
            f"{rl['t_compute_s']*1e3:.1f} | {rl['t_memory_s']*1e3:.1f} | "
            f"{rl['t_collective_s']*1e3:.1f} | {rl['dominant']} | "
            f"{rl.get('useful_ratio', 0):.2f} | "
            f"{rl.get('roofline_fraction', 0)*100:.0f}% | "
            f"{r['per_device']['peak_bytes']/2**30:.1f} | "
            f"{'yes' if r.get('fits') else 'no'} |")


def main():
    """Print the table of every dry-run JSON under ``--dir``."""
    import argparse, json, os
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args()
    rows = []
    for name in sorted(os.listdir(args.dir)):
        if name.endswith(".json"):
            with open(os.path.join(args.dir, name)) as f:
                rows.append(json.load(f))
    print("| arch | shape | epitome | mesh | t_comp ms | t_mem ms | t_coll ms "
          "| dominant | useful | roofline | GiB/dev | fits 80 GiB |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if "roofline" in r:
            print(format_row(r))


if __name__ == "__main__":
    main()
