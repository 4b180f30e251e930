"""Dry run: trace every (architecture x input shape x mesh) cell on fake
tensors in a fake world of the production mesh's size, and record per-rank
memory, FLOPs, each kernel's work and the collectives for the roofline
(counterpart of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k [--multi-pod] [--epitome folded] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--epitome folded]

The reference lowers and compiles each cell on 512 placeholder devices.
Torch has no such compile, so the port runs its own step instead: the
training step of ``train.loop.make_train_step``, ``lm.prefill`` or
``lm.decode_step``, exactly as a user calls them, on this rank's inputs,
under ``FakeTensorMode`` on the ``meta`` device (no storage, no device
touched) in a fake process group (``torch.testing._internal.distributed.
fake_pg``) of 256 or 512 ranks laid out as ``launch.mesh.
make_production_mesh``; this process is rank 0 of it.  The state is made as
a run makes it (``train.loop.init_state(mesh=)``, ``lm.prepack_params`` /
``shard_params``, ``lm.init_decode_state(mesh=)``), so each rank holds its
blocks of it.  Training splits a batch's rows over the batch axes ('pod',
'data'); serving gives every rank the whole batch, as the port serves.

From the trace (``trace_cell``):
* ``per_device``: ``argument_bytes`` (the step's inputs on this rank,
  exactly, each storage once), ``output_bytes``, ``alias_bytes`` (outputs
  that are inputs updated in place), the step's ``peak_bytes`` from a
  memory tracker (``MemTracker``; the inputs included), ``temp_bytes`` =
  peak - arguments - outputs + aliases, ``flops`` (the aten ops'
  ``FlopCounterMode`` count plus each kernel's operations) and
  ``bytes_accessed`` (every aten op's inputs and outputs, plus each
  kernel's bytes: the per-op bound);
* ``kernels``: each hand-written kernel's launches, operations, bytes and
  bound, from its wrapper's shape-only branch (``kernels.cost``): counted,
  not launched.  ``mamba_scan_bwd`` is counted though the card has no such
  kernel yet (ROADMAP item 7.13): a Mamba training step traces, but does
  not run on the card;
* ``collectives``: ``roofline.CollectiveCounter``'s bytes by op and by mesh
  axis;
* ``roofline``: ``roofline.roofline_terms`` on H100 data-sheet constants,
  a prediction, not a measurement; ``fits``: the peak within the card's
  80 GiB.

Cost probes: as the reference does, FLOPs, bytes and collectives are also
traced at 1 and 2 super-block groups and extrapolated linearly in depth to
the full model (``_probe_cfg``, ``_extrapolate``); the arguments and the
memory trace stay at full depth.  The reference needs the probes because
XLA counts a loop's body once; an eager trace counts every layer, so here
the probes are the cheap path (two shallow traces, no memory tracker:
``run_cell(skip_memory=True)``) and, where the full trace runs too, a
check on it: ``probe_vs_trace`` is each extrapolated count over the full
trace's, 1 when the counts grow linearly in depth.  The roofline
takes the full trace's exact counts when it ran, else the probes'.  Unlike
the reference's, a training probe keeps the step's ``grad_accum``: an
eager step gathers the weights at every microbatch, so one microbatch
would count a fraction of its collectives.  The reference's probe config
also widens the chunk sizes (its unroll bounds); the port's keeps them,
which set what the kernels count.

Nothing here starts a world on import.  ``run_cell`` and ``main`` start the
fake world in this process (which must have no process group), and a
caller that has a real process group runs the dry run as a subprocess
(``subprocess_command``, as ``chip_smoke.py`` does).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import SHAPES, ShapeCell, get_config, input_specs, shape_applicable
from ..kernels import cost
from ..models import lm
from ..models.common import batch_size, set_mesh
from ..models.config import ModelConfig
from ..train.loop import TrainConfig, init_state, make_train_step
from ..train.optimizer import AdamWConfig
from ..train.tree import leaves
from .mesh import make_production_mesh
from .roofline import _VOLUME_MULT, CollectiveCounter, roofline_terms

DEVICE = "meta"           # where the fake tensors say they live
_FAKE = None


def fake_mode():
    """This process's one ``FakeTensorMode``: tables the model caches by
    device (``kernels.ops.spec_tables``, ``core.epitome.fold_tables``,
    ``models.common.rope_freqs``) are made under it once and reused by
    every later cell, which one mode a cell would refuse."""
    global _FAKE
    if _FAKE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE = FakeTensorMode()
    return _FAKE


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------
def start_fake_world(world_size: int, rank: int = 0) -> None:
    """Start a fake process group of ``world_size`` ranks in this process
    (collectives return at once and move nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake world: run it in a process with "
                           "no process group (subprocess_command)")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def end_fake_world() -> None:
    set_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def production_mesh(multi_pod: bool):
    """``make_production_mesh`` over a fake world of its size."""
    start_fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


# ---------------------------------------------------------------------------
# Per-arch training knobs: the reference's, unchanged
# ---------------------------------------------------------------------------
def arch_overrides(arch: str, kind: str) -> Dict[str, Any]:
    """Per-arch knobs that keep the big models inside a card's memory."""
    o: Dict[str, Any] = {}
    if kind == "train":
        o["opt"] = AdamWConfig(
            moments_dtype="int8" if arch in
            ("grok-1-314b", "jamba-1.5-large-398b", "qwen1.5-110b") else "float32",
            master_dtype="float32")
        o["train"] = TrainConfig(
            grad_accum={
                "qwen2-72b": 8, "qwen1.5-110b": 8, "deepseek-67b": 8,
                "grok-1-314b": 8, "jamba-1.5-large-398b": 8,
                "internvl2-76b": 8, "phi3.5-moe-42b-a6.6b": 4,
            }.get(arch, 2),
            accum_dtype="bfloat16" if arch in
            ("grok-1-314b", "jamba-1.5-large-398b", "qwen1.5-110b")
            else "float32")
    return o


# ---------------------------------------------------------------------------
# What a traced step does
# ---------------------------------------------------------------------------
def _tensors(tree) -> list:
    """The local tensors of a tree (a laid-out leaf's block)."""
    from ..core.layers import local_of
    return [local_of(t) for t in leaves(tree) if isinstance(local_of(t), torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    """A tensor's storage, the same for every view of it while it lives."""
    return t.untyped_storage()._cdata


def _storage_bytes(tensors) -> int:
    """Bytes of the storages under ``tensors``, each counted once."""
    seen, total = set(), 0
    for t in tensors:
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


class StepCounter(TorchDispatchMode):
    """One mode for what a traced step does, op by op: its FLOPs (the
    formulas of ``torch.utils.flop_counter``: products and convolutions),
    the per-op bound of its memory traffic (every aten op's tensor inputs
    and outputs, views excluded, as XLA's ``bytes accessed``; a ``prim``
    op such as a fake tensor's ``.device`` reads no memory) and its
    collectives (``roofline.CollectiveCounter``)."""

    def __init__(self, mesh):
        from torch.utils.flop_counter import flop_registry
        super().__init__()
        self.registry = flop_registry
        self.coll = CollectiveCounter(mesh)
        self.flops = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self.coll.observe(func, args)
            return out
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func.namespace == "aten" and not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in torch.utils._pytree.tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _peak_tracker(args):
    """A ``MemTracker`` with the step's inputs counted from the start."""
    from torch.distributed._tools.mem_tracker import MemTracker
    mt = MemTracker()
    mt.track_external(*args)
    return mt


def _peak(mt) -> int:
    return int(sum(v["Total"] for v in mt.get_tracker_snapshot("peak").values()))


def _run(step, args, mesh, memory: bool) -> Dict[str, Any]:
    """Run ``step()`` under the counters (and, with ``memory``, the memory
    tracker over ``args``); returns its counts and its outputs."""
    import contextlib
    counter = StepCounter(mesh)
    mt = _peak_tracker(args) if memory else None
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if mt is not None:
            stack.enter_context(mt)
        stack.enter_context(counter)
        rec = stack.enter_context(cost.recording())
        out = step()
    kernels = rec.kernels
    return dict(out=out, seconds=time.perf_counter() - t0,
                flops=counter.flops + sum(k["flops"] for k in kernels.values()),
                bytes=counter.bytes + sum(k["bytes"] for k in kernels.values()),
                coll=counter.coll.result(), kernels=kernels,
                peak=_peak(mt) if mt is not None else None)


def _serving_params(cfg: ModelConfig, mesh):
    """The parameters as ``serve.build_model`` makes them on ``mesh``:
    drawn, then prepacked where a layer runs the fused int8 kernel (laid
    out by placement as they are packed), else laid out by the serving
    specs."""
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, DEVICE)
    if lm.needs_prepack(cfg):
        return lm.prepack_params(params, cfg, mesh=mesh)
    return lm.shard_params(params, cfg, mesh) if mesh is not None else params


def _rows(cell: ShapeCell, cfg: ModelConfig, n: int) -> Dict[str, torch.Tensor]:
    """This rank's inputs: the cell's ``input_specs`` (meta) with the
    batch's rows cut to ``n`` ranks' share."""
    out = {}
    for k, v in input_specs(cfg, cell).items():
        shape = (v.shape[0] // n,) + tuple(v.shape[1:]) if v.ndim else ()
        out[k] = torch.zeros(shape, dtype=v.dtype, device=DEVICE)
    return out


def trace_train(cfg: ModelConfig, cell: ShapeCell, mesh, opt_cfg: AdamWConfig,
                train_cfg: TrainConfig, memory: bool = True) -> Dict[str, Any]:
    """The port's training step (``make_train_step``) on this rank's rows
    of the cell's batch.  A microbatch gives every batch rank its share of
    rows, so ``grad_accum`` is cut to the largest divisor of the rank's
    rows it does not exceed (recorded as ``grad_accum``)."""
    n = batch_size(mesh)
    if cell.global_batch % n:
        raise ValueError(f"{cell.name}: a batch of {cell.global_batch} rows does not split "
                         f"over {n} batch ranks")
    rows = cell.global_batch // n
    accum = max(a for a in range(1, min(train_cfg.grad_accum, rows) + 1) if rows % a == 0)
    train_cfg = dataclasses.replace(train_cfg, grad_accum=accum)
    state = init_state(torch.Generator().manual_seed(0), cfg, opt_cfg, train_cfg, DEVICE,
                       mesh=mesh)
    batch = _rows(cell, cfg, n)
    step = make_train_step(cfg, opt_cfg, train_cfg)
    args = _tensors(state) + list(batch.values())
    r = _run(lambda: step(state, batch), args, mesh, memory)
    r.update(args=args, grad_accum=accum)
    return r


def trace_prefill(cfg: ModelConfig, cell: ShapeCell, mesh, memory: bool = True):
    """``lm.prefill`` of the whole batch (every rank serves every row), its
    decode state made inside the step, as the reference's prefill cell
    makes it."""
    params = _serving_params(cfg, mesh)
    inputs = _rows(cell, cfg, 1)["inputs"]
    B, S = inputs.shape[0], inputs.shape[1]

    def step():
        with torch.no_grad():
            state = lm.init_decode_state(cfg, B, S, DEVICE, mesh=mesh)
            return lm.prefill(params, inputs, state, cfg)
    args = _tensors(params) + [inputs]
    r = _run(step, args, mesh, memory)
    r.update(args=args, grad_accum=1)
    return r


def trace_decode(cfg: ModelConfig, cell: ShapeCell, mesh, memory: bool = True):
    """``lm.decode_step`` of the whole batch against a decode state of the
    cell's length, one token at its last position."""
    params = _serving_params(cfg, mesh)
    B, S = cell.global_batch, cell.seq_len
    state = lm.init_decode_state(cfg, B, S, DEVICE, mesh=mesh)
    tok = (torch.zeros((B, 1, cfg.d_model), dtype=torch.bfloat16, device=DEVICE)
           if cfg.embed_inputs else _rows(cell, cfg, 1)["token"])

    def step():
        with torch.no_grad():
            return lm.decode_step(params, state, tok, S - 1, cfg)
    args = _tensors(params) + _tensors(state) + [tok]
    r = _run(step, args, mesh, memory)
    r.update(args=args, grad_accum=1)
    return r


def trace_cell(cfg: ModelConfig, arch: str, cell: ShapeCell, mesh, memory: bool = True,
               opt_cfg: Optional[AdamWConfig] = None,
               train_cfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """Trace one cell under ``FakeTensorMode``: the step's counts and, with
    ``memory``, its memory (``per_device``)."""
    set_mesh(mesh)
    with fake_mode():
        if cell.kind == "train":
            ov = arch_overrides(arch, "train")
            r = trace_train(cfg, cell, mesh, opt_cfg or ov["opt"], train_cfg or ov["train"],
                            memory)
        elif cell.kind == "prefill":
            r = trace_prefill(cfg, cell, mesh, memory)
        else:
            r = trace_decode(cfg, cell, mesh, memory)
        if memory:
            r["per_device"] = _memory(r)
    for key in ("out", "args", "peak"):
        r.pop(key)
    return r


def _memory(r) -> Dict[str, int]:
    """per_device's bytes (the reference's fields) from a traced step."""
    args = r["args"]
    outs = [t for t in torch.utils._pytree.tree_leaves(r["out"]) if isinstance(t, torch.Tensor)]
    from ..core.layers import local_of
    outs += [local_of(t) for t in torch.utils._pytree.tree_leaves(r["out"])
             if not isinstance(t, torch.Tensor) and isinstance(local_of(t), torch.Tensor)]
    arg_st = {_storage_key(t) for t in args}
    arg_b, out_b = _storage_bytes(args), _storage_bytes(outs)
    alias_b = _storage_bytes([t for t in outs if _storage_key(t) in arg_st])
    peak = r["peak"]
    return dict(argument_bytes=arg_b, output_bytes=out_b, alias_bytes=alias_b,
                temp_bytes=peak - arg_b - out_b + alias_b, peak_bytes=peak)


# ---------------------------------------------------------------------------
# Cost probes
# ---------------------------------------------------------------------------
def _probe_cfg(cfg: ModelConfig, cell, groups: int) -> ModelConfig:
    """Cost-probe config: ``groups`` super-block repeats (the chunk sizes
    kept: see the module docstring)."""
    return dataclasses.replace(cfg, n_layers=groups * len(cfg.pattern))


def _cost_probe(cfg, arch, cell, mesh, groups: int, opt_cfg=None, train_cfg=None):
    """One probe: the cell's step traced at ``groups`` groups, no memory
    tracker; a training probe keeps the step's ``grad_accum`` (see the
    module doc)."""
    pc = _probe_cfg(cfg, cell, groups)
    r = trace_cell(pc, arch, cell, mesh, memory=False, opt_cfg=opt_cfg, train_cfg=train_cfg)
    return {"flops": r["flops"], "bytes": r["bytes"], "coll": r["coll"],
            "kernels": r["kernels"], "seconds": r["seconds"]}


def _extrapolate(p1: Dict, p2: Dict, n_groups: int) -> Dict[str, Any]:
    """Linear-in-depth extrapolation from 1- and 2-group probes."""
    def lin(a, b):
        # clamp, as the reference does (its compiler's noise); a trace has none
        return max(a + (n_groups - 1) * (b - a), max(a, 0.0))
    ops = set(p1["coll"]["bytes_by_op"]) | set(p2["coll"]["bytes_by_op"])
    by_op = {op: lin(p1["coll"]["bytes_by_op"].get(op, 0.0),
                     p2["coll"]["bytes_by_op"].get(op, 0.0)) for op in ops}
    counts = {op: round(lin(p1["coll"]["count_by_op"].get(op, 0),
                            p2["coll"]["count_by_op"].get(op, 0))) for op in ops}
    axes = set(p1["coll"]["weighted_by_axis"]) | set(p2["coll"]["weighted_by_axis"])
    by_axis = {a: lin(p1["coll"]["weighted_by_axis"].get(a, 0.0),
                      p2["coll"]["weighted_by_axis"].get(a, 0.0)) for a in axes}
    weighted = sum(_VOLUME_MULT.get(op, 1.0) * b for op, b in by_op.items())
    return {
        "flops": lin(p1["flops"], p2["flops"]),
        "bytes": lin(p1["bytes"], p2["bytes"]),
        "coll": {"bytes_by_op": by_op, "count_by_op": counts,
                 "raw_bytes": sum(by_op.values()), "weighted_bytes": weighted,
                 "weighted_by_axis": by_axis},
    }


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------
def _mesh_tag(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def run_cell(arch: str, shape, multi_pod: bool = False, epitome: str = "off",
             out_dir: Optional[str] = None, verbose: bool = True,
             skip_memory: bool = False, skip_probes: bool = False, tag: str = "",
             mesh=None, mesh_shape=None, opt_cfg: Optional[AdamWConfig] = None,
             train_cfg: Optional[TrainConfig] = None, cfg: Optional[ModelConfig] = None,
             **overrides) -> Dict[str, Any]:
    """Dry-run one cell: ``shape`` a ``SHAPES`` name or a ``ShapeCell``;
    ``overrides`` replace config fields (``n_layers=``, ...) of
    ``get_config(arch, epitome)``, or ``cfg`` is the config itself (a smoke
    config); ``opt_cfg`` / ``train_cfg`` replace the arch's training knobs.
    With no ``mesh`` a fake world is started here and ended after (this
    process must have no process group): the production mesh's, or, with
    ``mesh_shape`` ((data, model) or (pod, data, model)), one of that
    shape; a ``mesh`` given is a fake world's the caller started.  Returns
    the reference's fields plus ``kernels``, ``fits`` and
    ``collectives.bytes_by_axis``."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    own = mesh is None
    if own and mesh_shape is not None:
        from .mesh import make_host_mesh
        start_fake_world(math.prod(mesh_shape))
        mesh = make_host_mesh(*mesh_shape[-2:], "cpu",
                              pod=mesh_shape[0] if len(mesh_shape) == 3 else 1)
    elif own:
        mesh = production_mesh(multi_pod)
    try:
        cfg = cfg if cfg is not None else get_config(arch, epitome=epitome, **overrides)
        return _run_cell(arch, cell, mesh, cfg, epitome, out_dir, verbose, skip_memory,
                         skip_probes, tag, opt_cfg, train_cfg)
    finally:
        if own:
            end_fake_world()


def _run_cell(arch, cell, mesh, cfg, epitome, out_dir, verbose, skip_memory, skip_probes, tag,
              opt_cfg, train_cfg) -> Dict[str, Any]:
    t_start = time.perf_counter()
    n_chips = mesh.size()
    result: Dict[str, Any] = {
        "arch": arch, "shape": cell.name, "epitome": epitome, "mesh": _mesh_tag(mesh),
        "mesh_axes": list(mesh.mesh_dim_names), "n_chips": n_chips,
        "n_layers": cfg.n_layers, "torch": torch.__version__,
        "constants": "NVIDIA H100 SXM5 data sheet (predictions, not measurements)",
    }
    full = None
    if not skip_memory:
        full = trace_cell(cfg, arch, cell, mesh, True, opt_cfg, train_cfg)
        result["trace_s"] = full["seconds"]
        result["per_device"] = dict(full["per_device"], flops=full["flops"],
                                    bytes_accessed=full["bytes"])
        result["kernels"] = full["kernels"]
        result["grad_accum"] = full["grad_accum"]
        result["fits"] = full["per_device"]["peak_bytes"] <= cost.HBM_BYTES
    else:
        result["per_device"] = {"peak_bytes": -1}
    counts = full
    if not skip_probes:
        p1 = _cost_probe(cfg, arch, cell, mesh, 1, opt_cfg, train_cfg)
        p2 = _cost_probe(cfg, arch, cell, mesh, 2, opt_cfg, train_cfg)
        probes = _extrapolate(p1, p2, cfg.n_groups)
        result["probe_s"] = [p1["seconds"], p2["seconds"]]
        if full is not None:
            ratio = lambda a, b: a / b if b else None
            result["probe_vs_trace"] = {
                "flops": ratio(probes["flops"], full["flops"]),
                "bytes": ratio(probes["bytes"], full["bytes"]),
                "collective_bytes": ratio(probes["coll"]["raw_bytes"],
                                          full["coll"]["raw_bytes"])}
        else:
            counts = probes
            result["kernels"] = {
                k: {f: (p1["kernels"].get(k, {}).get(f, 0)
                        + (cfg.n_groups - 1) * (v[f] - p1["kernels"].get(k, {}).get(f, 0)))
                    for f in v} for k, v in p2["kernels"].items()}
    if counts is not None:
        result["per_device"]["flops"] = counts["flops"]
        result["per_device"]["bytes_accessed"] = counts["bytes"]
        result["collectives"] = dict(counts["coll"])
        accum = result.get("grad_accum", 1) if cell.kind == "train" else 1
        result["roofline"] = roofline_terms(
            {"flops": counts["flops"], "bytes accessed": counts["bytes"]},
            counts["coll"], cfg, cell, n_chips=n_chips, grad_accum=accum)
    result["seconds"] = time.perf_counter() - t_start
    if tag:
        result["tag"] = tag
    if verbose:
        pd, rl = result["per_device"], result.get("roofline", {})
        print(f"[dryrun] {arch} {cell.name} {result['mesh']} epitome={epitome}: "
              f"trace {result.get('trace_s', 0):.1f}s + probes {sum(result.get('probe_s', [])):.1f}s, "
              f"peak/device {pd['peak_bytes'] / 2**30:.2f} GiB"
              + (f" (fits 80 GiB: {result['fits']})" if "fits" in result else "")
              + (f", flops/device {pd['flops']:.3g}, bound {rl['bound_s'] * 1e3:.2f} ms "
                 f"({rl['dominant']}), useful {rl['useful_ratio']:.2f}" if rl else ""),
              flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = (f"{arch}_{cell.name}_{result['mesh']}_{epitome}"
                 + (f"_{tag}" if tag else "")).replace(".", "_")
        with open(os.path.join(out_dir, fname + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def encode_call(**kw) -> Dict[str, Any]:
    """``run_cell``'s keywords as JSON for ``--json-call`` (a ``ShapeCell``,
    ``AdamWConfig`` or ``TrainConfig`` by its fields)."""
    def enc(v):
        if dataclasses.is_dataclass(v):
            return {"__cls__": type(v).__name__, **dataclasses.asdict(v)}
        return v
    return {k: enc(v) for k, v in kw.items()}


def subprocess_command(calls) -> list:
    """The command that runs ``run_cell`` once for each of ``calls``
    (``encode_call`` dicts) in one fresh Python process, printing each
    result as a JSON line: for a caller with a process group of its own,
    or one that starts the dry run beside other work (``subprocess.Popen``
    with ``PYTHONPATH`` at this package's ``src``)."""
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--json-call", json.dumps(calls)]


def src_path() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _json_call(payload: str) -> None:
    kinds = {"ShapeCell": ShapeCell, "AdamWConfig": AdamWConfig, "TrainConfig": TrainConfig}
    for call in json.loads(payload):
        kw = {k: (kinds[v.pop("__cls__")](**v) if isinstance(v, dict) and "__cls__" in v else v)
              for k, v in call.items()}
        kw.setdefault("verbose", False)
        print(json.dumps(run_cell(**kw)), flush=True)


def main():
    ap = argparse.ArgumentParser(description="Dry-run (arch x shape x mesh) cells on fake "
                                             "tensors in a fake world; see the module doc.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--epitome", default="off",
                    choices=["off", "paper", "wrapped", "folded", "folded-q3"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-probes", action="store_true",
                    help="the full-depth trace only (its own counts feed the roofline)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--json-call", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.json_call is not None:
        return _json_call(args.json_call)

    from ..configs import ARCHS
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES if shape_applicable(a, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    mesh = production_mesh(args.multi_pod)
    t0 = time.perf_counter()
    try:
        for arch, shape in cells:
            run_cell(arch, shape, args.multi_pod, args.epitome, args.out,
                     skip_probes=args.skip_probes, mesh=mesh)
    finally:
        end_fake_world()
    print(f"[dryrun] all {len(cells)} cells OK in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
