"""Sharded serving across ranks: 8 gloo ranks on the CPU, one
``torch.multiprocessing.spawn`` group running every check in turn, and one
``torchrun`` of the plan CLI.

1. (2, 4) mesh, rwkv6-7b smoke from a searched plan legalized for that
   mesh: the int8 codes live on the ranks as blocks smaller than the whole,
   and the prefill logits and 8 greedy tokens (one-shot, and through
   ``EngineConfig(mesh="2,4")``) equal the same plan's whole on one rank,
   bit for bit.
2. (4, 2) mesh, phi3.5-moe smoke in float32 with capacity factor 8:
   ``moe_dispatch`` (all_to_all over the data ranks) within rel 1e-4 of
   ``moe_dense``, as the reference's tests/test_system.py holds its own.
3. ``moe_ffn`` takes the dispatch path at prefill and the dense path at a
   decode step.

The port is held to its own one-rank run, not to the reference's sharded
run: the cross-rank evidence of the reference comes from fake XLA devices.
"""
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

import pytest
import torch

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8


def _check_rwkv(plan_path: str) -> dict:
    from repro_torch.launch.engine import EngineConfig, Request
    from repro_torch.launch.mesh import mesh_for_plan
    from repro_torch.launch.serve import build_model, generate
    from repro_torch.core.layers import Sharded, axis_sizes
    from repro_torch.models import lm
    from repro_torch.models.common import set_mesh
    from repro_torch.pim.plan import EpitomePlan
    plan = EpitomePlan.load(plan_path)
    cfg, params = build_model("rwkv6-7b", "off", True, 0, "cpu", plan=plan)
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref_logits, _ = lm.prefill(params, prompts, lm.init_decode_state(cfg, 2, 17, "cpu"), cfg)
    ref_toks, _ = generate(params, cfg, prompts, 17, 8)

    mesh = mesh_for_plan(plan, 2, 4, "cpu")
    set_mesh(mesh)
    sharded = lm.prepack_params(params, cfg, mesh=mesh)
    split = [f"{name}: {tuple(v.local.shape)} of {tuple(v.shape)}"
             for g in sharded["groups"] for name, v in _named(g) if isinstance(v, Sharded)
             and v.is_split() and name.endswith("/Eq")]
    state = lm.init_decode_state(cfg, 2, 17, "cpu", mesh=mesh)
    state_split = sum(isinstance(v, Sharded) and v.is_split() for st in state
                      for _, v in _named(st))
    with torch.no_grad():
        sh_logits, _ = lm.prefill(sharded, prompts, state, cfg)
    sh_toks, _ = generate(sharded, cfg, prompts, 17, 8)

    eng = EngineConfig(arch="rwkv6-7b", plan=plan, smoke=True, mesh="2,4", capacity=2,
                       max_len=17, decode_block=4, seed=0, device="cpu").build()
    for row in prompts.tolist():
        eng.submit(Request(prompt=row, max_new_tokens=8))
    eng_toks = [list(c.tokens) for c in eng.drain()]
    return dict(mesh=axis_sizes(mesh), split_codes=split, state_split=state_split,
                logits_equal=torch.equal(ref_logits, sh_logits),
                tokens_equal=torch.equal(ref_toks, sh_toks), tokens=sh_toks.tolist(),
                engine_equal=eng_toks == ref_toks.tolist())


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _moe_setup():
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import set_mesh
    set_mesh(make_host_mesh(4, 2, "cpu"))
    cfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"), capacity_factor=8.0,
                              compute_dtype="float32", param_dtype="float32")
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(8, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    return moe, cfg, params, x


def _check_moe() -> dict:
    moe, cfg, params, x = _moe_setup()
    with torch.no_grad():
        y_dense = moe.moe_dense(params, x, cfg)
        y_disp = moe.moe_dispatch(params, x, cfg)
    err = float((y_dense - y_disp).abs().max())
    return dict(n_experts=cfg.n_experts, err=err, rel=err / float(y_dense.abs().max()))


def _check_moe_ffn() -> dict:
    moe, cfg, params, x = _moe_setup()
    taken, dispatch, dense = [], moe.moe_dispatch, moe.moe_dense
    moe.moe_dispatch = lambda *a: taken.append("dispatch") or dispatch(*a)
    moe.moe_dense = lambda *a: taken.append("dense") or dense(*a)
    try:
        with torch.no_grad():
            prefill = moe.moe_ffn(params, x, cfg)
            decode = moe.moe_ffn(params, x[:, :1], cfg)
            same = (torch.equal(prefill, dispatch(params, x, cfg))
                    and torch.equal(decode, dense(params, x[:, :1], cfg)))
    finally:
        moe.moe_dispatch, moe.moe_dense = dispatch, dense
    return dict(paths=taken, same_as_the_path=same)


def _rank(rank: int, world: int, store: str, plan_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as tmesh
    tmesh.init_world("cpu", store_path=store, rank=rank, world_size=world)
    out = {}
    try:
        out["rwkv"] = _check_rwkv(plan_path)
        out["moe"] = _check_moe()
        out["moe_ffn"] = _check_moe_ffn()
    except Exception:
        out["error"] = traceback.format_exc()
        raise
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    tmesh.destroy_world()


@pytest.fixture(scope="module")
def plan_path(tmp_path_factory):
    """rwkv6-7b smoke: searched (population 6, 3 iterations, seed 0, as the
    reference's test searches) and legalized for the (2, 4) mesh."""
    from repro_torch.pim.evo import EvoConfig
    from repro_torch.pim.plan import legalize_plan, search_plan
    plan = legalize_plan(search_plan(
        "rwkv6-7b-smoke", objective="latency", weight_bits=3, act_bits=9,
        evo=EvoConfig(population=6, iterations=3, seed=0)), mesh_shape={"data": 2, "model": 4})
    assert all(lp.placement is not None for lp in plan.layers)
    path = tmp_path_factory.mktemp("plan") / "q.json"
    plan.save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def ranks(plan_path, tmp_path_factory):
    """Every rank's results of one 8-rank group."""
    d = tmp_path_factory.mktemp("ranks")
    torch.multiprocessing.spawn(_rank, args=(WORLD, str(d / "store"), plan_path, str(d)),
                                nprocs=WORLD, join=True)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(WORLD)]


def test_sharded_rwkv_plan_bit_identical_to_one_rank(ranks):
    for r, out in enumerate(ranks):
        res = out["rwkv"]
        assert res["mesh"] == {"data": 2, "model": 4}
        assert res["split_codes"], f"rank {r}: no int8 code leaf ended up split"
        assert res["state_split"] > 0, f"rank {r}: the decode state stayed whole"
        assert res["logits_equal"] and res["tokens_equal"], (r, res)
        assert res["engine_equal"], (r, res)
    assert all(out["rwkv"]["tokens"] == ranks[0]["rwkv"]["tokens"] for out in ranks)


def test_moe_dispatch_matches_dense(ranks):
    for out in ranks:
        assert out["moe"]["n_experts"] == 4
        assert out["moe"]["rel"] < 1e-4, out["moe"]


def test_moe_ffn_dispatches_prefill_and_decodes_dense(ranks):
    for out in ranks:
        assert out["moe_ffn"]["paths"] == ["dispatch", "dense"], out["moe_ffn"]
        assert out["moe_ffn"]["same_as_the_path"]


def test_plan_run_mesh_cli(plan_path):
    """``plan run --mesh 2,4`` under torchrun checks sharded against one
    rank itself and prints both lines."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT / "src"),
                                                        os.environ.get("PYTHONPATH")])))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(WORLD), "-m", "repro_torch.launch.plan", "run", "--plan", plan_path,
         "--mesh", "2,4", "--device", "cpu", "--iters", "1"],
        capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "logits bit-identical=True" in out.stdout, out.stdout
    assert "tokens bit-identical=True" in out.stdout, out.stdout
    assert "{'data': 2, 'model': 4} over 8 rank(s)" in out.stdout, out.stdout
