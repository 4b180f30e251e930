"""Meshes (counterpart of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` of shape (data, model),
its dims named ``("data", "model")``, or (pod, data, model) with a 'pod'
axis before them, over every rank of the running world: one process a
card (or, on the CPU, a process a rank).  Under ``torchrun``
the mesh joins the world that ``torchrun`` describes (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` in the environment); with no process group
and no such environment it starts a world of one itself, whose rendezvous
is a ``FileStore`` in a temporary directory (no port to collide on when
several test workers start one at once).  The backend is NCCL on ``cuda``
and gloo on ``cpu``; a ``cuda`` mesh over a gloo group is refused.

    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.plan \\
        run --plan q.json --mesh 2,4 --device cpu     # 8 gloo ranks
    PYTHONPATH=src python -m repro_torch.launch.plan run --plan q.json \\
        --mesh 1,1                                     # one card, NCCL

A weight laid out on the mesh (``core.layers.Sharded``) is gathered at the
layer that reads it.  Serving, every rank computes every row, so a rank's
tokens are the whole batch's.  Training (``train.loop``), a batch's rows
are split over the batch axes (``models.common.BATCH_AXES``: 'data', and
'pod' where a mesh has it; ``models.common.batch_size`` / ``batch_rank``)
while the ranks of a 'model' group compute the same rows, so 'model' saves
memory, not compute.  Only rank 0 prints (``is_main``).

``make_production_mesh`` is the H100 cluster the dry run
(``launch.dryrun``) lays a cell out on: (data, model) = (32, 8), 256
cards, or (pod, data, model) = (2, 32, 8), 512, the reference's card
counts.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \
        -m repro_torch.launch.train --arch rwkv6-7b --smoke \
        --epitome folded-q3 --device cpu              # (8, 1), gloo
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import warnings
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..core.layers import axis_sizes

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")

# the rendezvous directory of the world of one this module started, if any
_OWN_STORE: Optional[str] = None


def init_world(device="cuda", store_path: Optional[str] = None, rank: int = 0,
               world_size: int = 1) -> int:
    """Join or start the process group a mesh runs over; returns the world
    size.  An initialized group is kept (it must be NCCL for ``cuda``).
    Under ``torchrun`` the group is joined through the environment;
    otherwise through a ``FileStore`` at ``store_path`` (the ranks of one
    test share it: ``rank`` of ``world_size``), or in a new temporary
    directory for a world of one."""
    global _OWN_STORE
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if device.type == "cuda" and dist.get_backend() != "nccl":
            raise RuntimeError(f"a cuda mesh needs an NCCL process group, not "
                               f"{dist.get_backend()!r}")
        return dist.get_world_size()
    kw = {}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if store_path is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, **kw)               # torchrun: env://
        return dist.get_world_size()
    if store_path is None:
        _OWN_STORE = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        store_path = os.path.join(_OWN_STORE, "store")
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, **kw)
    return dist.get_world_size()


def destroy_world() -> None:
    """Tear the process group down (and the mesh installed on the model
    side), removing the rendezvous directory of a world this module
    started."""
    global _OWN_STORE
    from ..models.common import set_mesh
    set_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()
    if _OWN_STORE is not None:
        shutil.rmtree(_OWN_STORE, ignore_errors=True)
        _OWN_STORE = None


def make_host_mesh(data: int = 1, model: int = 1, device="cuda", pod: int = 1):
    """A (data, model) mesh over the ranks of the running world (started
    as a world of one when there is none); with ``pod`` > 1 a (pod, data,
    model) mesh.

    The requested shape is clamped to the world's size, with a warning when
    it degrades, so throughput is attributable to the mesh that actually
    ran.  A mesh that covers fewer ranks than the world is refused: every
    rank serves on it."""
    from torch.distributed.device_mesh import init_device_mesh
    n = init_world(device)
    want = (data, model)
    data = max(1, min(data, n // pod))
    model = max(1, min(model, n // (pod * data)))
    if (data, model) != want:
        warnings.warn(f"requested mesh (data, model)={want} clamped to ({data}, {model}): "
                      f"only {n} rank(s) in the world", stacklevel=2)
    if pod * data * model != n:
        raise ValueError(f"mesh (pod, data, model)=({pod}, {data}, {model}) covers "
                         f"{pod * data * model} of the world's {n} ranks; every rank "
                         f"serves on the mesh")
    if pod > 1:
        return _with_batch_group(init_device_mesh(torch.device(device).type, (pod, data, model),
                                                  mesh_dim_names=POD_AXES))
    return init_device_mesh(torch.device(device).type, (data, model), mesh_dim_names=AXES)


def _with_batch_group(mesh):
    """A (pod, data, model) mesh with its batch axes' group made now
    (``models.moe.batch_group``, the MoE dispatch's): making a group is a
    collective of every rank, so it is not left to a layer's forward."""
    from ..models.moe import batch_group
    batch_group(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The H100 cluster a dry-run cell is laid out on, over the running
    world, which must have its size (the dry run's is a fake world of
    that size: ``launch.dryrun``):

    * (data, model) = (32, 8): 256 cards;
    * (pod, data, model) = (2, 32, 8): 512 cards.

    These are the reference's card counts (its 16 x 16 and 2 x 16 x 16 TPU
    pods), so the cells compare in size.  'model' is 8 because an HGX
    H100 node joins its 8 cards over NVLink 4 and NVSwitch
    (``kernels.cost.NVLINK_BW``), and the 'model' axis gathers a layer's
    weight at every layer, so it stays inside a node; 'data' and 'pod'
    cross nodes over InfiniBand (``kernels.cost.IB_BW`` a card), whose
    collectives run once a step (the gradient sums) or once an MoE layer
    (the dispatch)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = ((2, 32, 8), POD_AXES) if multi_pod else ((32, 8), AXES)
    n = dist.get_world_size() if dist.is_initialized() else 0
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs a world of "
                         f"{math.prod(shape)} ranks, the running world has {n}")
    mesh = init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axes)
    return _with_batch_group(mesh) if multi_pod else mesh


def parse_mesh(flag: str) -> Tuple[int, int]:
    """Parse a ``--mesh DATA,MODEL`` flag value (e.g. ``2,4``)."""
    try:
        data, model = (int(v) for v in flag.split(","))
    except ValueError:
        raise ValueError(f"--mesh expects 'DATA,MODEL' (e.g. 2,4), got {flag!r}") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh sizes must be >= 1, got {flag!r}")
    return data, model


def mesh_for_plan(plan, data: int = 1, model: int = 1, device="cuda"):
    """The (data, model) mesh an EpitomePlan serves on, with the plan's
    placement annotations legalized against it: every annotated axis must
    exist in the mesh and divide the layer's (m, n); offenders are reported
    as warnings (they degrade to replicated at the tensor layer).  The plan
    is not changed, so the same artifact can be checked against another
    mesh."""
    from ..pim.plan import legalize_placements
    mesh = make_host_mesh(data=data, model=model, device=device)
    _, report = legalize_placements(plan, axis_sizes(mesh))
    for name, reasons in report.items():
        warnings.warn(f"plan {plan.arch!r} layer {name!r}: " + "; ".join(reasons),
                      stacklevel=2)
    return mesh


def resolve_mesh(flag: Optional[str], plan=None, device="cuda"):
    """The mesh of a ``--mesh`` flag (``EngineConfig.mesh``): ``'D,M'`` a
    (D, M) mesh (``mesh_for_plan`` with a plan); ``''`` the world that is
    running, all of it on 'data' (None when there is no process group:
    one card); None: None, as is."""
    if flag is None:
        return None
    if flag:
        data, model = parse_mesh(flag)
        return (mesh_for_plan(plan, data, model, device) if plan is not None
                else make_host_mesh(data, model, device))
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        return None
    return make_host_mesh(data=init_world(device), model=1, device=device)


def is_main() -> bool:
    """True on rank 0, the rank that prints (before the group is joined,
    the rank ``torchrun`` gives; with neither, True)."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", "0")) == 0


def say(*args, **kw) -> None:
    """``print`` on rank 0 only."""
    if is_main():
        print(*args, **kw)


def describe(mesh) -> str:
    """The mesh's axes and sizes ((pod,) data, model), the world's size
    and backend."""
    if mesh is None:
        return "none (one device, no process group)"
    return (f"{axis_sizes(mesh)} over {dist.get_world_size()} rank(s) "
            f"({dist.get_backend()}, {mesh.device_type})")
