"""Training on a mesh across ranks: 8 gloo ranks on the CPU in one
``torch.multiprocessing.spawn`` group running every check in turn (under a
timeout), and the train CLI under ``torchrun`` on 4 ranks, then resumed on
2 (the reference's ``tests/test_system.py`` holds its own on fake XLA
devices).

1. (1, 8), qwen2-72b smoke in float32, ``grad_accum=2``: no rows split, so
   the loss and every gathered gradient equal one rank's bit for bit (a
   sum over 'model' would show as an 8x gradient).
2. (8, 1) and (4, 2), the same config over 3 steps from the reference's
   parameters (``convert.lm_params_from_jax``): step 1's loss and gathered
   gradients within the float32 tolerance of one rank's and of
   ``jax.value_and_grad`` of the reference on the whole batch; the loss
   finite and ``embed`` moving (the reference's ``:90``); the parameters
   after 3 steps near one rank's; on (4, 2) the split blocks add up to the
   whole.
3. grok smoke in float32 at capacity factor 8, on (8, 1) (2 replicas an
   expert) and (4, 2) (each expert's d_ff split over 'model'):
   ``moe_dispatch`` within rel 1e-4 of ``moe_dense`` forward and every
   MoE leaf's gradient, the router's too, and the input's within 1e-3 (the
   reference's ``:58``).
4. (1, 8), int8 moments and ``compress_grads`` with leaves whose last dim
   splits below 256: residuals, codes and scales equal one rank's bit for
   bit.
5. deepseek-67b smoke, an int8-moment state on (4, 2) saved and restored
   onto (2, 4) and onto no mesh, every leaf bit for bit (the reference's
   ``:157``); a step after the restore near (4, 2)'s continuation.
6. SIGTERM on one rank: every rank checkpoints the same step and stops.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
SPAWN_TIMEOUT = 240       # seconds for the whole group
# float32: tests/test_torch_train.py's tolerance, relative to each gradient
# leaf's largest magnitude
F32_TOL = 1e-4
# the parameters after 3 AdamW steps (lr 1e-3) from gradients float32 apart:
# an element's update is m / sqrt(v), about +-lr for any gradient, so an
# element whose gradient the two runs round to opposite signs moves up to
# 2 lr apart a step; held at that bound over 3 steps, and most elements far
# closer (the relative L2 distance of the updates below 1e-2)
LR, STEPS = 1e-3, 3
B, S = 16, 16


def _qwen_cfg():
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen2-72b"), compute_dtype="float32")


def _batches(vocab):
    """STEPS numpy batches of B x S, every token counted."""
    out = []
    for seed in range(STEPS):
        toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": np.ones((B, S), np.float32)})
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _whole(p, t):
    """The whole tensor of block ``t`` of laid-out ``p`` (``t`` if ``p`` is
    not laid out)."""
    from repro_torch.core.layers import Sharded
    with torch.no_grad():
        return p.like(t).full() if isinstance(p, Sharded) else t


def _wholes(tree):
    from repro_torch.core.layers import unshard
    from repro_torch.train.tree import leaves
    with torch.no_grad():
        return [unshard(t).clone() for t in leaves(tree)]


def _state_from(params, cfg, opt, mesh):
    from repro_torch.models import lm
    from repro_torch.train import optimizer
    if mesh is not None:
        params = lm.shard_params(params, cfg, mesh, serving=False)
    return {"params": params, "opt": optimizer.adamw_init(params, opt),
            "step": torch.zeros((), dtype=torch.int32)}


# -- the checks each rank runs ------------------------------------------------
def _check_model_axis() -> dict:
    """1: (1, 8), no rows split: bit for bit against this process's own
    one-rank run."""
    from repro_torch.core.layers import Sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import set_mesh
    from repro_torch.train import loop, optimizer
    from repro_torch.train.tree import leaves
    cfg, opt = _qwen_cfg(), optimizer.AdamWConfig(lr=LR)
    tc = loop.TrainConfig(grad_accum=2)
    batch = _torch(_batches(cfg.vocab)[0])
    set_mesh(None)
    one = loop.init_state(torch.Generator().manual_seed(0), cfg, opt, tc, "cpu")
    l1, g1 = loop.loss_and_grads(one["params"], batch, cfg, tc)
    mesh = make_host_mesh(1, 8, "cpu")
    set_mesh(mesh)
    st = loop.init_state(torch.Generator().manual_seed(0), cfg, opt, tc, "cpu", mesh=mesh)
    loss, g = loop.loss_and_grads(st["params"], batch, cfg, tc)
    got = [_whole(p, x) for p, x in zip(leaves(st["params"]), leaves(g))]
    set_mesh(None)
    split = sum(isinstance(p, Sharded) and p.is_split() for p in leaves(st["params"]))
    return dict(loss_equal=float(loss) == float(l1), split=split,
                grads_equal=all(torch.equal(a, b) for a, b in zip(got, leaves(g1))),
                ratio=max(float(a.abs().max() / b.abs().max().clamp_min(1e-30))
                          for a, b in zip(got, leaves(g1))))


def _check_rows_split(data: str, out_dir: str, rank: int) -> dict:
    """2: (8, 1) and (4, 2) from the reference's parameters (``data``):
    step 1's loss and gradients, 3 steps, the layout's bytes."""
    from repro_torch.core.layers import Sharded, local_of
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import batch_rank, batch_size, set_mesh
    from repro_torch.train import loop, optimizer
    from repro_torch.train.data import host_rows
    from repro_torch.train.tree import leaves
    cfg, opt = _qwen_cfg(), optimizer.AdamWConfig(lr=LR)
    tc = loop.TrainConfig(grad_accum=2)
    batches = [_torch(b) for b in _batches(cfg.vocab)]
    out = {}
    for shape in ((8, 1), (4, 2)):
        mesh = make_host_mesh(*shape, "cpu")
        set_mesh(mesh)
        st = _state_from(torch.load(data), cfg, opt, mesh)
        embed0 = _whole(st["params"]["embed"], st["params"]["embed"].local).clone()
        rows = lambda b: host_rows(b, batch_rank(), batch_size(), tc.grad_accum)
        loss, g = loop.loss_and_grads(st["params"], rows(batches[0]), cfg, tc)
        grads = [_whole(p, x) for p, x in zip(leaves(st["params"]), leaves(g))]
        loop.apply_grads(st, g, opt, tc)
        step = loop.make_train_step(cfg, opt, tc)
        losses = [float(loss)]
        for b in batches[1:]:
            st, m = step(st, rows(b))
            losses.append(float(m["loss"]))
        final = _wholes(st["params"])
        tag = "x".join(map(str, shape))
        if rank == 0:
            torch.save({"loss": float(loss), "grads": grads, "final": final},
                       os.path.join(out_dir, f"rows_{tag}.pt"))
        laid = leaves(st["params"])
        local = sum(local_of(t).numel() * local_of(t).element_size() for t in leaves(st))
        whole = sum(t.numel() * t.element_size() for t in _wholes(st))
        out[tag] = dict(losses=losses, embed_moved=not torch.equal(embed0, final[0]),
                        numels=[t.local.numel() if isinstance(t, Sharded) else None
                                for t in laid],
                        split_axes=[list(t.split_axes()) if isinstance(t, Sharded) else []
                                    for t in laid],
                        whole_numels=[t.numel() for t in final],
                        state_bytes=local, whole_state_bytes=whole)
        set_mesh(None)
    return out


def _check_moe(shape) -> dict:
    """3: grok smoke on ``shape``: dispatch against dense, forward and every
    gradient."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.layers import lay_out, local_of
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import batch_rank, batch_size, set_mesh, split_rows
    from repro_torch.train import loop
    import torch.distributed as dist
    cfg = dataclasses.replace(get_smoke_config("grok-1-314b"), capacity_factor=8.0,
                              compute_dtype="float32", param_dtype="float32")
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 8, cfg.d_model)).astype(np.float32))
    dense = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xd = x.clone().requires_grad_(True)
    y_dense = moe.moe_dense(dense, xd, cfg)
    *g_dense, dx_dense = torch.autograd.grad((y_dense ** 2).sum(), list(dense.values()) + [xd])
    mesh = make_host_mesh(*shape, "cpu")
    set_mesh(mesh)
    laid = {k: lay_out(v.clone(), moe.moe_param_specs(cfg)[k], mesh) for k, v in params.items()}
    locs = [local_of(v).requires_grad_(True) for v in laid.values()]
    r, n = batch_rank(), batch_size()
    rows = x.shape[0] // n
    x_mine = x[r * rows:(r + 1) * rows].clone().requires_grad_(True)
    with split_rows():
        y = moe.moe_dispatch(laid, x_mine, cfg)
        *g, dx = torch.autograd.grad((y ** 2).sum(), locs + [x_mine])
    g = loop._sum_over_batch(laid, list(g))
    want = dx_dense[r * rows:(r + 1) * rows]
    rel_dx = float((dx - want).abs().max() / want.abs().max())
    parts = [torch.empty_like(y) for _ in range(WORLD)]
    dist.all_gather(parts, y.detach().contiguous())
    y_all = torch.cat(parts[::WORLD // n])      # one rank of each model group
    try:                     # the whole batch on every rank: no gradient
        moe.moe_dispatch(laid, x.clone().requires_grad_(True), cfg)
        whole_refused = False
    except NotImplementedError:
        whole_refused = True
    set_mesh(None)
    err = float((y_all - y_dense.detach()).abs().max())
    rel_y = err / float(y_dense.detach().abs().max())
    rel_g = {k: float((_whole(p, a) - b).abs().max() / (b.abs().max() + 1e-9))
             for (k, p), a, b in zip(laid.items(), g, g_dense)}
    return dict(n_experts=cfg.n_experts, rel_y=rel_y, rel_g=rel_g, rel_dx=rel_dx,
                router_nonzero=bool(g_dense[0].abs().max() > 0), whole_refused=whole_refused,
                laid=[type(v).__name__ for v in laid.values()])


def _check_int8_and_compression() -> dict:
    """4: (1, 8), int8 moments and int8 gradients with error feedback, two
    steps, against one rank, with ``grad_clip`` 0 and at its default 1.
    The clip divides by the global norm, whose split leaves' squares add in
    another order than one rank's, so with the clip active the state is
    held at a tolerance (the test's), without it bit for bit."""
    from repro_torch.core.layers import Sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import set_mesh
    from repro_torch.train import loop, optimizer
    from repro_torch.train.tree import leaves
    cfg = _qwen_cfg()
    tc = loop.TrainConfig(compress_grads=True)
    batches = [_torch(b) for b in _batches(cfg.vocab)[:2]]
    out = {}
    for clip in (0.0, optimizer.AdamWConfig().grad_clip):
        opt = optimizer.AdamWConfig(lr=LR, moments_dtype="int8", grad_clip=clip)
        runs, norms, p0 = [], [], None
        for shape in (None, (1, 8)):
            mesh = None if shape is None else make_host_mesh(*shape, "cpu")
            set_mesh(mesh)
            st = loop.init_state(torch.Generator().manual_seed(0), cfg, opt, tc, "cpu",
                                 mesh=mesh)
            p0 = _wholes(st["params"])
            step = loop.make_train_step(cfg, opt, tc)
            for b in batches:
                st, m = step(st, b)
                norms.append(float(m["grad_norm"]))
            runs.append({k: _wholes(st[k]) for k in ("params", "opt", "ef_residual")})
            set_mesh(None)
            narrow = sum(isinstance(p, Sharded) and p.local.shape[-1] < min(256, p.shape[-1])
                         for p in leaves(st["params"]))
        one, mesh_run = runs
        half = len(norms) // 2
        out[f"clip={clip:g}"] = {
            **{k: all(torch.equal(a, b) for a, b in zip(one[k], mesh_run[k])) for k in one},
            "narrow_last_dims": narrow, "norms": norms[:half],
            "norm_rel": max(abs(a - b) / b for a, b in zip(norms[half:], norms[:half])),
            "param_max": max(float((a - b).abs().max())
                             for a, b in zip(mesh_run["params"], one["params"])),
            "param_rel_l2": max(float((a - b).norm() / (b - s).norm().clamp_min(1e-30))
                                for a, b, s in zip(mesh_run["params"], one["params"], p0)),
            "codes_equal": float(np.mean([torch.equal(a, b) for a, b in
                                          zip(one["opt"], mesh_run["opt"])]))}
    return out


def _check_gather_backward() -> dict:
    """The gather's backward on (4, 2), a weight split over both axes:
    inside ``split_rows`` the data ranks' gradients are summed (the same
    integer-valued gradient on every rank: 4x this rank's block, exactly);
    outside, every rank computed every row and keeps its own block."""
    import contextlib
    from repro_torch.core.layers import distribute
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import set_mesh, split_rows
    mesh = make_host_mesh(4, 2, "cpu")
    set_mesh(mesh)
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    c = torch.from_numpy(np.random.default_rng(2).integers(-8, 8, (8, 4)).astype(np.float32))
    sh, block = distribute(w, ("data", "model"), mesh), distribute(c, ("data", "model"), mesh)
    out = {}
    for name, rows, times in (("rows_split", split_rows, 4.0),
                              ("rows_whole", contextlib.nullcontext, 1.0)):
        local = sh.local.clone().requires_grad_(True)
        with rows():
            g, = torch.autograd.grad((sh.like(local).full() * c).sum(), [local])
        out[name] = torch.equal(g, block.local * times)
    set_mesh(None)
    return out


def _check_elastic(ckpt_dir: str) -> dict:
    """5: deepseek smoke, int8 moments: one step on (4, 2), saved; restored
    onto (2, 4) and onto no mesh; a step after the restore."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.layers import Sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import batch_rank, batch_size, set_mesh
    from repro_torch.train import loop, optimizer
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import SyntheticData, host_rows
    from repro_torch.train.tree import leaves
    cfg = dataclasses.replace(get_smoke_config("deepseek-67b"), compute_dtype="float32")
    opt = optimizer.AdamWConfig(lr=LR, moments_dtype="int8")
    tc = loop.TrainConfig()
    data = SyntheticData(cfg.vocab, S, 8)
    step = loop.make_train_step(cfg, opt, tc)
    rows = lambda i: host_rows(data.batch(i), batch_rank(), batch_size())
    mgr = CheckpointManager(ckpt_dir, async_write=False)
    mesh = make_host_mesh(4, 2, "cpu")
    set_mesh(mesh)
    st = loop.init_state(torch.Generator().manual_seed(0), cfg, opt, tc, "cpu", mesh=mesh)
    st, _ = step(st, rows(0))
    saved = _wholes(st)
    mgr.save(1, st, blocking=True)
    import torch.distributed as dist
    dist.barrier()
    st, _ = step(st, rows(1))
    cont = _wholes(st["params"])
    split_42 = sum(isinstance(t, Sharded) and t.is_split() for t in leaves(st))
    mesh = make_host_mesh(2, 4, "cpu")
    set_mesh(mesh)
    target = loop.init_state(torch.Generator().manual_seed(1), cfg, opt, tc, "cpu", mesh=mesh)
    at, restored = mgr.restore(target, shardings=loop.state_specs(cfg, target))
    on_24 = all(torch.equal(a, b) for a, b in zip(saved, _wholes(restored)))
    split_24 = sum(isinstance(t, Sharded) and t.is_split() for t in leaves(restored))
    restored, m = step(restored, rows(1))
    after = _wholes(restored["params"])
    set_mesh(None)
    target = loop.init_state(torch.Generator().manual_seed(1), cfg, opt, tc, "cpu")
    _, one = mgr.restore(target)
    on_one = all(torch.equal(a, b) for a, b in zip(saved, _wholes(one)))
    dist_max = max(float((a - b).abs().max()) for a, b in zip(after, cont))
    return dict(step=at, on_2x4=on_24, on_one=on_one, leaves=len(saved), split_4x2=split_42,
                split_2x4=split_24, finite=all(bool(torch.isfinite(t).all()) for t in after),
                loss=float(m["loss"]), max_dist=dist_max)


def _check_sigterm(ckpt_dir: str, rank: int) -> dict:
    """6: rank 3 alone gets SIGTERM during step 1 of 6."""
    import signal
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import set_mesh
    from repro_torch.train import loop, optimizer
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import SyntheticData
    cfg, opt = _qwen_cfg(), optimizer.AdamWConfig(lr=LR)
    tc = loop.TrainConfig(checkpoint_every=100)
    mesh = make_host_mesh(8, 1, "cpu")
    set_mesh(mesh)
    st = loop.init_state(torch.Generator().manual_seed(0), cfg, opt, tc, "cpu", mesh=mesh)
    step = loop.make_train_step(cfg, opt, tc)

    def step_fn(state, batch):
        if rank == 3 and int(state["step"]) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(state, batch)
    mgr = CheckpointManager(ckpt_dir)
    st, hist = loop.train_loop(st, step_fn, SyntheticData(cfg.vocab, S, 8), 6, ckpt=mgr,
                               train_cfg=tc, log=lambda *a: None)
    set_mesh(None)
    import torch.distributed as dist
    dist.barrier()
    return dict(steps_run=len(hist["loss"]), state_step=int(st["step"]),
                latest=mgr.latest_step())


def _rank(rank: int, world: int, store: str, out_dir: str, data: str) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as tmesh
    tmesh.init_world("cpu", store_path=store, rank=rank, world_size=world)
    out = {}
    try:
        out["model_axis"] = _check_model_axis()
        out["rows_split"] = _check_rows_split(data, out_dir, rank)
        out["moe"] = {"x".join(map(str, s)): _check_moe(s) for s in ((8, 1), (4, 2))}
        out["int8"] = _check_int8_and_compression()
        out["gather"] = _check_gather_backward()
        out["elastic"] = _check_elastic(os.path.join(out_dir, "elastic"))
        out["sigterm"] = _check_sigterm(os.path.join(out_dir, "sigterm"), rank)
    except Exception:
        out["error"] = traceback.format_exc()
        raise
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
        tmesh.destroy_world()


def _spawn(fn, args, nprocs: int, timeout: float) -> None:
    """``torch.multiprocessing.spawn`` that fails, killing the ranks, when
    the group outlasts ``timeout`` seconds (a collective left waiting)."""
    ctx = torch.multiprocessing.start_processes(fn, args=args, nprocs=nprocs, join=False,
                                                start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"the {nprocs}-rank group did not end within {timeout} s")


# -- the reference side, in this process ---------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """qwen2-72b smoke (float32) from the reference's init: the parameters
    the ranks load, jax.value_and_grad on the whole first batch, and one
    rank's port run (step 1's loss and gradients, 3 steps)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import lm as jlm
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.train import loop, optimizer
    from repro_torch.train.tree import leaves
    cfg = _qwen_cfg()
    jc = dataclasses.replace(jget_smoke("qwen2-72b"), compute_dtype="float32")
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jc))
    batches = _batches(cfg.vocab)
    jloss, jg = jax.value_and_grad(jlm.loss_fn)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batches[0].items()}, jc)
    d = tmp_path_factory.mktemp("train_mesh")
    path = str(d / "qwen_params.pt")
    torch.save(lm_params_from_jax(tree, cfg, "cpu"), path)
    opt, tc = optimizer.AdamWConfig(lr=LR), loop.TrainConfig(grad_accum=2)
    st = _state_from(lm_params_from_jax(tree, cfg, "cpu"), cfg, opt, None)
    loss, g = loop.loss_and_grads(st["params"], _torch(batches[0]), cfg, tc)
    one_grads = [t.clone() for t in leaves(g)]
    loop.apply_grads(st, g, opt, tc)
    step = loop.make_train_step(cfg, opt, tc)
    for b in batches[1:]:
        st, _ = step(st, _torch(b))
    return dict(dir=d, params=path, jloss=float(jloss),
                jgrads=leaves(lm_params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu")),
                loss=float(loss), grads=one_grads, p0=leaves(torch.load(path)),
                final=[t.detach().clone() for t in leaves(st["params"])])


@pytest.fixture(scope="module")
def ranks(reference):
    """Every rank's results of one 8-rank group."""
    d = reference["dir"]
    _spawn(_rank, (WORLD, str(d / "store"), str(d), reference["params"]), WORLD,
           SPAWN_TIMEOUT)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(WORLD)]


def test_model_axis_mesh_is_one_rank_bit_for_bit(ranks):
    for r, out in enumerate(ranks):
        res = out["model_axis"]
        assert res["split"] > 0, f"rank {r}: nothing split over 'model'"
        assert res["loss_equal"] and res["grads_equal"], (r, res)


def _close(got, want, tol=F32_TOL):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert err <= tol * scale, f"leaf {i}: {err:.3e} > {tol} * {scale:.3e}"


@pytest.mark.parametrize("tag", ["8x1", "4x2"])
def test_rows_split_mesh_matches_one_rank_and_reference(ranks, reference, tag):
    got = torch.load(reference["dir"] / f"rows_{tag}.pt")
    assert abs(got["loss"] - reference["loss"]) <= F32_TOL * reference["loss"]
    assert abs(got["loss"] - reference["jloss"]) <= F32_TOL * reference["jloss"]
    _close(got["grads"], reference["grads"])
    _close(got["grads"], reference["jgrads"])
    for r, out in enumerate(ranks):
        res = out["rows_split"][tag]
        assert all(np.isfinite(res["losses"])) and res["embed_moved"], (r, res)
        assert res["losses"] == ranks[0]["rows_split"][tag]["losses"], r
    for i, (a, b, p0) in enumerate(zip(got["final"], reference["final"], reference["p0"])):
        assert float((a - b).abs().max()) <= 2 * STEPS * LR, i
        moved = float((b - p0).norm())
        if moved > 0:
            assert float((a - b).norm()) <= 1e-2 * moved, i


def test_four_by_two_blocks_add_up_to_the_whole(ranks):
    per_rank = [out["rows_split"]["4x2"] for out in ranks]
    whole, both = per_rank[0]["whole_numels"], 0
    for i, n in enumerate(whole):
        if per_rank[0]["numels"][i] is None:
            continue
        axes = per_rank[0]["split_axes"][i]
        copies = WORLD // {(): 1, ("data",): 4, ("model",): 2}.get(tuple(axes), 8)
        assert sum(p["numels"][i] for p in per_rank) == n * copies, i
        both += axes == ["data", "model"]
    assert both > 0, "no leaf is split over both axes"
    res = per_rank[0]
    print(f"(4, 2) rank 0 holds {res['state_bytes']} of the training state's "
          f"{res['whole_state_bytes']} bytes")
    assert res["state_bytes"] < res["whole_state_bytes"] / 2


@pytest.mark.parametrize("tag", ["8x1", "4x2"])
def test_moe_dispatch_gradients_match_dense(ranks, tag):
    for out in ranks:
        res = out["moe"][tag]
        assert res["n_experts"] == 4 and res["router_nonzero"], res
        assert res["laid"].count("Sharded") == 3, res
        assert res["rel_y"] < 1e-4, res
        assert all(v < 1e-3 for v in res["rel_g"].values()) and res["rel_dx"] < 1e-3, res


def test_moe_dispatch_refuses_a_gradient_of_the_whole_batch(ranks):
    """Outside ``split_rows`` the dispatch gathers the whole batch back
    through a plain all_gather: with autograd live it raises rather than
    drop the MoE branch's gradient."""
    for out in ranks:
        assert all(out["moe"][tag]["whole_refused"] for tag in ("8x1", "4x2")), out["moe"]


def test_gather_backward_sums_over_data_only_with_the_rows_split(ranks):
    for out in ranks:
        assert out["gather"] == {"rows_split": True, "rows_whole": True}, out["gather"]


def test_int8_moments_and_compression_bit_for_bit_on_model_axis(ranks):
    for out in ranks:
        res = out["int8"]["clip=0"]
        assert res["narrow_last_dims"] > 0, res
        assert res["params"] and res["opt"] and res["ef_residual"], res
        assert res["norm_rel"] <= 1e-6, res


# the default clip (1) on (1, 8): the norm is one rank's within float32
# rounding, so the clip factor may differ in its last bits, an int8 moment
# code may round the other way, and an element's AdamW update moves by up
# to 2 lr a step (as in the rows-split test); over 2 steps held at that
# bound, and the parameters' distance at 1e-2 of how far they moved
def test_int8_moments_and_compression_with_the_default_clip_on_model_axis(ranks):
    for out in ranks:
        res = out["int8"]["clip=1"]
        assert res["narrow_last_dims"] > 0, res
        assert all(n > 1 for n in res["norms"]), res        # the clip is active
        assert res["norm_rel"] <= 1e-6, res
        assert res["param_max"] <= 2 * 2 * LR and res["param_rel_l2"] <= 1e-2, res


def test_elastic_restore_onto_another_mesh_and_no_mesh(ranks):
    for out in ranks:
        res = out["elastic"]
        assert res["step"] == 1 and res["on_2x4"] and res["on_one"], res
        assert res["split_4x2"] > 0 and res["split_2x4"] > 0, res
        assert res["finite"] and np.isfinite(res["loss"]), res
        assert res["max_dist"] <= 2 * LR, res


def test_sigterm_on_one_rank_stops_every_rank_at_one_step(ranks, reference):
    for out in ranks:
        assert out["sigterm"] == {"steps_run": 2, "state_step": 2, "latest": 2}, out["sigterm"]
    assert (reference["dir"] / "sigterm" / "step_00000002" / "DONE").exists()


def _torchrun(n: int, args: list, timeout: int = 240) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT / "src"),
                                                        os.environ.get("PYTHONPATH")])))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(n), "-m", "repro_torch.launch.train", "--arch", "rwkv6-7b", "--smoke",
         "--epitome", "folded-q3", "--device", "cpu", "--seq", "32", *args],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_train_cli_resumes_on_another_world_size(tmp_path):
    """``launch.train`` on 4 ranks checkpoints at step 10; on 2 ranks with
    more steps it restores that checkpoint and trains on."""
    ckpt = str(tmp_path / "ckpt")
    first = _torchrun(4, ["--steps", "10", "--ckpt-dir", ckpt])
    assert "[train] mesh: {'data': 4, 'model': 1} over 4 rank(s) (gloo, cpu)" in first, first
    assert "[train] done" in first and first.count("[train] done") == 1, first
    second = _torchrun(2, ["--steps", "14", "--ckpt-dir", ckpt])
    assert "{'data': 2, 'model': 1} over 2 rank(s)" in second, second
    assert "[train] restored checkpoint at step 10" in second, second
    assert "[train] done" in second, second
