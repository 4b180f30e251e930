"""The dry run (``launch.dryrun``) on fake worlds, each started in a
subprocess (never in the test worker):

1. Layout parity at full size: qwen2-72b ``train_4k`` under its overrides
   on a fake 256-rank (16, 16) world, the port's per-rank local shapes of
   the whole training state against the reference's ``NamedSharding``
   shard shapes (its ``state_sharding_tree`` on 256 placeholder XLA
   devices, in a second subprocess), leaf by leaf, matched by path; then
   jamba smoke with int8 moments on (2, 2, 2) (pod, data, model).  The
   int8 moments' scales are kept whole along the last dim by the port
   (``train/loop.state_specs``): they are left out of the match and their
   byte difference is held below 1 % of the state.
2. The counterpart of ``tests/test_system.py::test_mini_multipod_dryrun``:
   jamba smoke, int8 moments, ``grad_accum=2`` on a fake (2, 2, 2) world,
   B = 8, S = 32: the step traces, ``temp_bytes >= 0``, and the
   collectives hold the MoE dispatch's all_to_all over the (pod, data)
   group.
3. FLOP sanity with ``epitome off`` through the 1- and 2-group probes:
   qwen2-72b and rwkv6-7b at full width, ``train_4k``, on a fake (8, 1)
   world have a useful ratio in [0.6, 0.8] (the remat recomputes the
   forward: about 6 N D of 8 N D is useful); rwkv6-7b's counted FLOPs are
   8 N D of its products' parameters within 5 %, and ``product_params``
   is that N within 0.1 % (it leaves out the token-shift mixes); on
   (8, 2) the per-rank FLOPs equal (8, 1)'s, because 'model' saves
   memory, not compute, in this port.
4. The probes against the full trace: phi3.5-moe smoke (its dispatch
   runs over the (pod, data) group) at three groups on the fake (2, 2, 2)
   world, ``grad_accum=2``: each extrapolated count (FLOPs, per-op bytes,
   collective bytes) within 1e-3 of the full trace's (the per-op bytes
   count a table the model caches once a process: 3e-6 apart here).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ROOT = Path(__file__).resolve().parents[1]


def _py(code: str, timeout: int = 300, env=None) -> dict:
    """Run ``code`` in a fresh Python; its last stdout line is JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **(env or {}))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=timeout, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


PORT_LAYOUT = """
    import json, torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import set_mesh
    from repro_torch.train.loop import TrainConfig, init_state
    from repro_torch.train.optimizer import AdamWConfig
    SHAPE, ARCH, SMOKE, INT8 = {shape}, {arch!r}, {smoke}, {int8}
    dryrun.start_fake_world(int(torch.tensor(SHAPE).prod()))
    mesh = make_host_mesh(*SHAPE[-2:], "cpu", pod=SHAPE[0] if len(SHAPE) == 3 else 1)
    set_mesh(mesh)
    if SMOKE:
        cfg, opt, tc = (get_smoke_config(ARCH), AdamWConfig(moments_dtype="int8"),
                        TrainConfig(grad_accum=2))
    else:
        ov = dryrun.arch_overrides(ARCH, "train")
        cfg, opt, tc = get_config(ARCH), ov["opt"], ov["train"]
    def named(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from named(v, prefix + "/" + k)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from named(v, prefix + "/" + str(i))
        else:
            yield prefix, tree
    with dryrun.fake_mode():
        st = init_state(torch.Generator().manual_seed(0), cfg, opt, tc, "meta", mesh=mesh)
        out = {{}}
        for path, t in named(st):
            local = getattr(t, "local", t)
            out[path] = [list(local.shape), local.numel() * local.element_size()]
    print(json.dumps(out))
"""

REF_LAYOUT = """
    import json, math
    import numpy as np
    from repro.launch import dryrun          # sets 512 placeholder XLA devices
    import jax
    from jax.sharding import Mesh
    from repro.configs import get_config, get_smoke_config
    from repro.models.common import set_mesh
    from repro.train.loop import TrainConfig
    from repro.train.optimizer import AdamWConfig
    SHAPE, ARCH, SMOKE = {shape}, {arch!r}, {smoke}
    axes = ("pod", "data", "model") if len(SHAPE) == 3 else ("data", "model")
    mesh = Mesh(np.array(jax.devices()[:math.prod(SHAPE)]).reshape(SHAPE), axes)
    set_mesh(mesh)
    if SMOKE:
        cfg, opt, tc = (get_smoke_config(ARCH), AdamWConfig(moments_dtype="int8"),
                        TrainConfig(grad_accum=2))
    else:
        ov = dryrun.arch_overrides(ARCH, "train")
        cfg, opt, tc = get_config(ARCH), ov["opt"], ov["train"]
    shape, specs = dryrun.state_sharding_tree(cfg, mesh, tc, opt)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    flat_s = jax.tree_util.tree_flatten_with_path(shape)[0]
    # int8 moments: each param spec stands for a (codes, scales) pair
    def spec_of(path):
        node = specs
        for k in path:
            key = getattr(k, "key", getattr(k, "idx", None))
            if is_spec(node):
                break
            node = node[key]
        return node
    out = {{}}
    for path, sds in flat_s:
        spec = spec_of(path)
        local = dryrun.named(mesh, tuple(spec), sds.shape).shard_shape(sds.shape)
        name = "".join("/" + str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[name] = [list(local), int(np.prod(local)) * sds.dtype.itemsize]
    print(json.dumps(out))
"""


def _norm(path: str) -> str:
    """A port path with its group index dropped: /params/groups/3/L0/..
    -> /params/groups/L0/.. (the reference stacks the groups on an axis)."""
    parts = path.split("/")
    if "groups" in parts:
        i = parts.index("groups")
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            del parts[i + 1]
    return "/".join(parts)


def _layout(shape, arch, smoke, int8):
    port = _py(PORT_LAYOUT.format(shape=shape, arch=arch, smoke=smoke, int8=int8), 600)
    ref = _py(REF_LAYOUT.format(shape=shape, arch=arch, smoke=smoke), 600)
    scale = lambda p: int8 and p.startswith(("/opt/m/", "/opt/v/")) and p.endswith("/1")
    matched, port_bytes, ref_bytes, scale_port, scale_ref = 0, 0, 0, 0, 0
    for path, (local, nbytes) in port.items():
        key = _norm(path)
        assert key in ref, f"{path}: no reference leaf {key}"
        r_local = ref[key][0]
        grouped = key != path
        port_bytes += nbytes
        if scale(path):
            scale_port += nbytes
            continue
        want = r_local[1:] if grouped else r_local
        assert local == want, f"{path}: port's block {local}, reference's {want}"
        matched += 1
    for key, (_, r_bytes) in ref.items():
        ref_bytes += r_bytes
        if scale(key):
            scale_ref += r_bytes
    return dict(matched=matched, leaves=len(port), port_bytes=port_bytes, ref_bytes=ref_bytes,
                scale_port=scale_port, scale_ref=scale_ref)


@pytest.mark.parametrize("shape,arch,smoke,int8", [
    ((16, 16), "qwen2-72b", False, False),
    ((2, 2, 2), "jamba-1.5-large-398b", True, True),
])
def test_layout_matches_the_reference_leaf_by_leaf(shape, arch, smoke, int8):
    res = _layout(shape, arch, smoke, int8)
    diff = abs(res["scale_port"] - res["scale_ref"])
    print(f"{arch} {shape}: {res['matched']} of {res['leaves']} leaves matched; state "
          f"{res['port_bytes']} bytes a rank (reference {res['ref_bytes']}); the int8 "
          f"scales {res['scale_port']} against {res['scale_ref']} bytes")
    assert res["matched"] > 0
    assert diff < 0.01 * res["port_bytes"], res
    if not int8:
        assert res["port_bytes"] == res["ref_bytes"], res


def test_mini_multipod_dryrun_traces_the_step():
    """Counterpart of test_system.py's test_mini_multipod_dryrun: the
    port's real training step on a fake (2, 2, 2) world."""
    res = _py("""
        import json
        from repro_torch.configs import ShapeCell, get_smoke_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.train.loop import TrainConfig
        from repro_torch.train.optimizer import AdamWConfig
        dryrun.start_fake_world(8)
        mesh = make_host_mesh(2, 2, "cpu", pod=2)
        r = dryrun.run_cell("jamba-1.5-large-398b", ShapeCell("mini", 32, 8, "train"),
                            mesh=mesh, cfg=get_smoke_config("jamba-1.5-large-398b"),
                            opt_cfg=AdamWConfig(moments_dtype="int8"),
                            train_cfg=TrainConfig(grad_accum=2), skip_probes=True,
                            verbose=False)
        dryrun.end_fake_world()
        print(json.dumps(r))
    """)
    pd = res["per_device"]
    assert pd["temp_bytes"] >= 0 and pd["peak_bytes"] >= pd["argument_bytes"] > 0, pd
    assert res["grad_accum"] == 2
    coll = res["collectives"]
    assert coll["bytes_by_axis"]["pod_data"]["all-to-all"] > 0, coll
    assert set(coll["bytes_by_axis"]) >= {"pod", "data", "model", "pod_data"}, coll
    # 14 Mamba layers a microbatch: the forward and the recompute each count
    # a launch of the scan, the backward one of its gradient kernel
    assert res["kernels"]["mamba_scan"]["launches"] == 2 * 2 * 14
    assert res["kernels"]["mamba_scan_bwd"]["launches"] == 2 * 14
    assert res["fits"] and res["roofline"]["bound_s"] > 0


def test_flops_through_the_probes():
    res = _py("""
        import json
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun, roofline
        out = {}
        for shape in ((8, 1), (8, 2)):
            dryrun.start_fake_world(shape[0] * shape[1])
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            for arch in ("qwen2-72b", "rwkv6-7b"):
                r = dryrun.run_cell(arch, "train_4k", epitome="off", skip_memory=True,
                                    mesh=mesh, verbose=False)
                # the parameters the step multiplies by: every matrix but
                # the embedding (a lookup), drawn on fake tensors
                from repro_torch.models import lm
                from repro_torch.train.tree import leaves
                with dryrun.fake_mode():
                    p = lm.init_params(torch.Generator(), get_config(arch), "meta")
                    n = sum(t.numel() for t in leaves({k: v for k, v in p.items()
                                                       if k != "embed"}) if t.ndim >= 2)
                out["x".join(map(str, shape)) + " " + arch] = dict(
                    flops=r["per_device"]["flops"], useful=r["roofline"]["useful_ratio"],
                    products=n, counted=roofline.product_params(get_config(arch)),
                    probe_s=r["probe_s"])
            dryrun.end_fake_world()
        print(json.dumps(out))
    """, 600)
    tokens = 256 * 4096 // 8              # a data rank's rows of train_4k
    qwen, rwkv = res["8x1 qwen2-72b"], res["8x1 rwkv6-7b"]
    assert 0.6 <= qwen["useful"] <= 0.8, qwen
    assert 0.6 <= rwkv["useful"] <= 0.8, rwkv
    assert abs(rwkv["flops"] / (8 * rwkv["products"] * tokens) - 1) < 0.05, rwkv
    for arch in ("qwen2-72b", "rwkv6-7b"):
        assert res["8x2 " + arch]["flops"] == res["8x1 " + arch]["flops"], arch
        r = res["8x1 " + arch]
        assert abs(r["counted"] / r["products"] - 1) < 1e-3, (arch, r)


def test_probes_match_the_full_trace():
    res = _py("""
        import dataclasses, json
        from repro_torch.configs import ShapeCell, get_smoke_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.train.loop import TrainConfig
        from repro_torch.train.optimizer import AdamWConfig
        dryrun.start_fake_world(8)
        mesh = make_host_mesh(2, 2, "cpu", pod=2)
        cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
        cfg = dataclasses.replace(cfg, n_layers=3 * len(cfg.pattern))
        r = dryrun.run_cell("phi3.5-moe-42b-a6.6b", ShapeCell("mini", 32, 8, "train"),
                            mesh=mesh, cfg=cfg, opt_cfg=AdamWConfig(moments_dtype="int8"),
                            train_cfg=TrainConfig(grad_accum=2), verbose=False)
        dryrun.end_fake_world()
        print(json.dumps(r))
    """)
    assert res["grad_accum"] == 2 and len(res["probe_s"]) == 2
    assert res["collectives"]["bytes_by_axis"]["pod_data"]["all-to-all"] > 0
    for count, ratio in res["probe_vs_trace"].items():
        assert abs(ratio - 1) < 1e-3, (count, res["probe_vs_trace"])
