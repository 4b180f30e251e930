"""Training driver (counterpart of ``repro.launch.train``).

On the CPU, the smoke config of an arch (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b --smoke \\
      --epitome folded-q3 --steps 20 --device cpu

On the card, rwkv6-7b at full width and depth (32 layers, 2.3e9
parameters; WKV forward and backward kernels):
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --epitome folded-q3 --steps 6 --batch 8 --seq 256

On a mesh, under torchrun (8 gloo ranks on the CPU; one card a rank, NCCL):
  PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --standalone --nproc-per-node 8 \
      -m repro_torch.launch.train --arch rwkv6-7b --smoke --epitome folded-q3 \
      --device cpu

Fault tolerance: with --ckpt-dir, a checkpoint every N steps (async), one on
SIGTERM, and a restart resumes from the latest complete checkpoint, on any
number of ranks (the elastic restart).  Under ``torchrun``, or in a running
process group, the run trains on a (world, 1) mesh, every rank on 'data'
(``mesh.resolve_mesh('')``), as the reference trains on a host mesh of all
its devices: the parameters and optimizer state laid out by the training
specs, each rank its rows of every batch; rank 0 prints.  With no world,
one device and no mesh.  ``--device`` picks the device (default cuda).
Training runs the fake-quant modes ('folded', 'folded-q3'); the kernel
modes are inference-only and refuse a backward.
"""
from __future__ import annotations

import argparse
import math

import torch
import torch.distributed as dist

from ..configs import get_config, get_smoke_config
from ..models.common import set_mesh
from ..train.checkpoint import CheckpointManager
from ..train.data import SyntheticData
from ..train.loop import TrainConfig, init_state, make_train_step, train_loop
from ..train.optimizer import AdamWConfig
from ..train.tree import leaves
from .mesh import describe, destroy_world, resolve_mesh, say


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--epitome", default="off")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config(args.arch, args.epitome) if args.smoke
           else get_config(args.arch, args.epitome))
    device = torch.device(args.device)
    owned = not dist.is_initialized()          # a world this run starts, it ends
    mesh = resolve_mesh("", device=device)
    set_mesh(mesh)
    try:
        return _run(args, cfg, device, mesh)
    finally:
        if mesh is not None and owned:
            destroy_world()


def _run(args, cfg, device, mesh):
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    train_cfg = TrainConfig(grad_accum=args.grad_accum,
                            compress_grads=args.compress_grads,
                            checkpoint_every=max(10, args.steps // 5))
    data = SyntheticData(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                         seed=args.seed, embed_dim=cfg.d_model if cfg.embed_inputs else 0)
    if mesh is not None:
        say(f"[train] mesh: {describe(mesh)}", flush=True)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    state = init_state(torch.Generator(device=device).manual_seed(args.seed), cfg,
                       opt_cfg, train_cfg, device, mesh=mesh)
    if ckpt is not None and ckpt.latest_step() is not None:
        step, state = ckpt.restore(state)
        say(f"[train] restored checkpoint at step {step}")
    n_params = sum(math.prod(p.shape) for p in leaves(state["params"]))
    say(f"[train] {cfg.name} epitome={args.epitome} on {device}: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}, {n_params} parameters; batch "
        f"{args.batch} x {args.seq}", flush=True)

    step_fn = make_train_step(cfg, opt_cfg, train_cfg)
    state, hist = train_loop(state, step_fn, data, args.steps, ckpt=ckpt,
                             train_cfg=train_cfg, log=say)
    if hist["loss"]:
        times = sorted(hist["step_time"][1:] or hist["step_time"])
        say(f"[train] done: first loss {hist['loss'][0]:.4f} -> "
            f"last {hist['loss'][-1]:.4f}; median step {times[len(times) // 2] * 1e3:.1f} ms "
            f"({args.batch * args.seq / times[len(times) // 2]:.0f} tokens/s); "
            f"stragglers flagged: {len(hist['stragglers'])}")
    return state, hist


if __name__ == "__main__":
    main()
