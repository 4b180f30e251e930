"""The dry run's yardsticks against the reference's, in-process: the shape
cells and ``param_count`` (``configs``, ``models.config``), the roofline's
arithmetic (``launch.roofline``) on the reference's TPU constants, the
collective term by mesh axis, each kernel's work (``kernels.cost``) against
the bounds ``PERF.md`` prints, and every kernel wrapper's shape-only branch
against its plain version on the CPU."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels import cost
from repro_torch.launch import roofline as troof

jax = pytest.importorskip("jax")
from repro import configs as rconfigs  # noqa: E402
from repro.launch import mesh as rmesh  # noqa: E402
from repro.launch import roofline as rroof  # noqa: E402

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

VARIANTS = ("off", "paper", "wrapped", "folded", "folded-q3", "kernel", "kernel-q3")
CELLS = [(a, s) for a in rconfigs.ARCHS for s in rconfigs.SHAPES]
REL = 1e-12


# -- registry -----------------------------------------------------------------------
def test_shapes_equal_the_reference_field_by_field():
    assert list(tconfigs.SHAPES) == list(rconfigs.SHAPES)
    for name, cell in rconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.SHAPES[name]) == dataclasses.asdict(cell)
    assert tconfigs.LONG_CONTEXT_OK == rconfigs.registry.LONG_CONTEXT_OK


@pytest.mark.parametrize("arch,shape", CELLS)
def test_shape_applicable_and_input_specs(arch, shape):
    assert tconfigs.shape_applicable(arch, shape) == rconfigs.shape_applicable(arch, shape)
    got = tconfigs.input_specs(tconfigs.get_config(arch), shape)
    want = rconfigs.input_specs(rconfigs.get_config(arch), shape)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype), k


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_param_count_equals_the_reference(arch):
    for variant in VARIANTS:
        t, r = tconfigs.get_config(arch, variant), rconfigs.get_config(arch, variant)
        assert t.param_count() == r.param_count(), variant
        assert t.param_count(active_only=True) == r.param_count(active_only=True), variant


# -- roofline -----------------------------------------------------------------------
def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0)


# the reference's TPU v5e constants, every axis over its 4 ICI links
TPU = troof.Chip(rmesh.PEAK_FLOPS_BF16, rmesh.HBM_BW, {}, rroof.ICI_LINKS * rmesh.ICI_BW)


@pytest.mark.parametrize("arch,shape", [c for c in CELLS if rconfigs.shape_applicable(*c)])
def test_roofline_arithmetic_equals_the_reference(arch, shape):
    tcell, rcell = tconfigs.SHAPES[shape], rconfigs.SHAPES[shape]
    for variant in ("off", "folded-q3", "kernel-q3"):
        t, r = tconfigs.get_config(arch, variant), rconfigs.get_config(arch, variant)
        _close(troof.model_flops(t, tcell), rroof.model_flops(r, rcell))
        _close(troof._n_attn(t), rroof._n_attn(r))
        _close(troof._state_bytes(t, 128, 32768), rroof._state_bytes(r, 128, 32768))
        for chips, accum in ((256, 8), (512, 2)):
            for minimal in (False, True):
                _close(troof.analytic_hbm_bytes(t, tcell, chips, accum, minimal=minimal),
                       rroof.analytic_hbm_bytes(r, rcell, chips, accum, minimal=minimal))
        # the whole roofline on the reference's TPU constants and a collective
        # payload charged whole (no axes), as the reference charges it
        counted = {"flops": 3.7e14, "bytes accessed": 9.1e12}
        coll = {"bytes_by_op": {"all-reduce": 2e9, "all-gather": 5e9},
                "count_by_op": {"all-reduce": 3, "all-gather": 4}, "raw_bytes": 7e9,
                "weighted_bytes": 9e9}
        got = troof.roofline_terms(counted, coll, t, tcell, 256, 8, chip=TPU)
        want = rroof.roofline_terms(counted, coll, r, rcell, 256, 8)
        for key in ("t_compute_s", "t_memory_s", "t_memory_xla_bound_s", "t_collective_s",
                    "bound_s", "model_flops"):
            _close(got[key], want[key])
        assert got["dominant"] == want["dominant"]
        # the shares, the reference's arithmetic with one stated change: they
        # read the port's useful_flops where the reference reads MODEL_FLOPS
        useful = troof.useful_flops(t, tcell)
        _close(got["useful_flops"], useful)
        _close(got["useful_ratio"], want["useful_ratio"] * useful / want["model_flops"])
        ideal_m = rroof.analytic_hbm_bytes(r, rcell, 256, 8, minimal=True) / rmesh.HBM_BW
        _close(got["ideal_s"], max(useful / (256 * rmesh.PEAK_FLOPS_BF16), ideal_m))
        _close(got["roofline_fraction"], got["ideal_s"] / want["bound_s"])


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_useful_flops_count_the_products_as_multiplied(arch):
    """``product_params`` counts an epitomized site at its epitome: an
    epitome variant's count is the dense one less each site's (M N - m n);
    a prefill's head multiplies each row's last token only."""
    from repro_torch.models.lm import lm_layer_configs
    from repro_torch.pim.workloads import lm_layers
    dense = troof.product_params(tconfigs.get_config(arch, "off"))
    for variant in VARIANTS[1:]:
        cfg = tconfigs.get_config(arch, variant)
        lcs = lm_layer_configs(cfg)
        saved = sum(s.rows * s.cols - lcs[s.name].spec.m * lcs[s.name].spec.n
                    for s in lm_layers(cfg) if lcs[s.name].spec is not None)
        assert saved > 0, variant
        assert troof.product_params(cfg) == dense - saved * cfg.n_groups, variant
    cfg = tconfigs.get_config(arch, "kernel-q3")
    n, head = troof.product_params(cfg, active_only=True), cfg.d_model * cfg.vocab
    B, S = 4, 256
    cell = tconfigs.ShapeCell("p", S, B, "prefill")
    _close(troof.useful_flops(cfg, cell), 2.0 * (n - head) * B * S + 2.0 * head * B)
    for kind, per in (("train", 6.0 * B * S), ("decode", 2.0 * B)):
        _close(troof.useful_flops(cfg, tconfigs.ShapeCell("c", S, B, kind)), per * n)


def test_collective_term_by_axis_on_h100():
    """'model' over one direction of NVLink 4, 'data', 'pod' and their
    flattened group over the card's InfiniBand adapter; the axes add."""
    coll = {"bytes_by_op": {}, "count_by_op": {}, "raw_bytes": 0.0, "weighted_bytes": 0.0,
            "weighted_by_axis": {"model": 9e9, "data": 1e9, "pod": 5e8, "pod_data": 2.5e8}}
    want = 9e9 / 450e9 + 1e9 / 50e9 + 5e8 / 50e9 + 2.5e8 / 50e9
    _close(troof.collective_seconds(coll, troof.H100), want)
    cfg, cell = tconfigs.get_config("qwen2-72b"), tconfigs.SHAPES["train_4k"]
    rl = troof.roofline_terms({"flops": 0.0, "bytes accessed": 0.0}, coll, cfg, cell, 256, 8)
    _close(rl["t_collective_s"], want)
    assert rl["dominant"] == "collective" and rl["bound_s"] == rl["t_collective_s"]
    assert troof.H100.peak_flops == 989e12 and troof.H100.hbm_bw == 3.35e12


def test_collective_counter_sums_output_bytes_by_axis():
    """The counter reads each c10d op's output tensors and its group's
    axis, on a fake (2, 2, 2) world of 8 started in a subprocess (the fake
    process group moves nothing); the production mesh refuses that world."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = textwrap.dedent("""
        import json, torch, torch.distributed as dist
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.moe import batch_group
        from repro_torch.launch.mesh import make_production_mesh
        dryrun.start_fake_world(8)
        try:                       # the production mesh needs 256 (or 512) ranks
            make_production_mesh(device="cpu")
            refused = False
        except ValueError:
            refused = True
        mesh = make_host_mesh(2, 2, "cpu", pod=2)
        with dryrun.fake_mode(), dryrun.StepCounter(mesh) as c:
            x = torch.zeros(4, 8, device="meta")
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x, group=mesh.get_group("model"))
            dist.all_reduce(x, group=mesh.get_group("data"))
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=batch_group(mesh))
        print(json.dumps(dict(c.coll.result(), refused=refused)))
        dryrun.end_fake_world()
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bytes_by_axis"] == {"model": {"all-gather": 256.0},
                                    "data": {"all-reduce": 128.0},
                                    "pod_data": {"all-to-all": 128.0}}
    assert res["weighted_by_axis"] == {"model": 256.0, "data": 256.0, "pod_data": 128.0}
    assert res["count_by_op"] == {"all-gather": 1, "all-reduce": 1, "all-to-all": 1}
    assert res["refused"]


USEFUL_CELLS = """
    import json, warnings
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    warnings.simplefilter("ignore")          # kernel-exact snaps at smoke widths
    dryrun.start_fake_world(1)
    mesh = make_host_mesh(1, 1, "cpu")
    out = {}
    for variant in ("off", "paper", "wrapped", "folded", "folded-q3", "kernel", "kernel-q3"):
        cfg = get_smoke_config(ARCH, variant)
        for cell in (ShapeCell("t", 16, 4, "train"), ShapeCell("p", 16, 2, "prefill"),
                     ShapeCell("d", 16, 2, "decode")):
            if cell.kind == "train" and variant not in ("off", "folded", "folded-q3"):
                continue
            rl = dryrun.run_cell(ARCH, cell, mesh=mesh, cfg=cfg, epitome=variant,
                                 skip_probes=True, verbose=False)["roofline"]
            out[variant + " " + cell.kind] = [rl["useful_ratio"], rl["roofline_fraction"]]
    dryrun.end_fake_world()
    print(json.dumps(out))
"""


@pytest.mark.parametrize("arch", ["rwkv6-7b", "qwen2-72b", "phi3.5-moe-42b-a6.6b"])
def test_useful_flops_bound_every_counted_step(arch):
    """No counted step falls below ``useful_flops``: at smoke widths, on a
    fake world of one started in a subprocess, every epitome variant's
    prefill and decode step, and the training step of those that train
    without rebuilding a dense weight (``paper`` and ``wrapped`` multiply
    more, the ``kernel`` modes serve only), has a useful ratio and a
    roofline fraction in (0, 1]."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = f"ARCH = {arch!r}\n" + textwrap.dedent(USEFUL_CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res) == 17
    for cell, (useful, fraction) in res.items():
        assert 0 < useful <= 1 and 0 < fraction <= 1, (cell, useful, fraction)


# -- kernels.cost ---------------------------------------------------------------------
def _ms(name, nbytes, flops, dtype="float32", products=None):
    return float(f"{cost.bound_seconds(name, nbytes, flops, dtype, products)[0] * 1e3:.3g}")


def test_kernel_counts_give_perf_md_bounds():
    """PERF.md's kernel table, bound a launch, to the 3 figures it prints:
    the WKV at rwkv6-7b's prefill (4 x 256, 64 heads of 64, a state in),
    bf16 and float32 r, k, v; its gradient at phase 13's 8 x 256, bf16,
    a zero state in; the scan at jamba's 4 x 256 x 16384 x 16, bf16."""
    B, S, H, K = 4, 256, 64, 64
    flops, products = cost.wkv6_ops(B, S, H, K, 64)
    assert _ms(cost.WKV, cost.wkv6_bytes(B, S, H, K, 2), flops, "bfloat16", products) == 0.0200
    assert _ms(cost.WKV, cost.wkv6_bytes(B, S, H, K, 4), flops, "float32", products) == 0.0275
    B = 8
    assert _ms(cost.WKV_BWD, cost.wkv_bwd_bytes(B, S, H, K, 2, True, False),
               cost.wkv_bwd_ops(B, S, H, K), "bfloat16",
               cost.wkv_bwd_chunked_ops(B, S, H, K)) == 0.0801
    assert _ms(cost.SCAN, cost.scan_bytes(4, 256, 16384, 16, 2), cost.scan_ops(4, 256, 16384, 16),
               "bfloat16") == 0.0429


# -- the shape-only branches -------------------------------------------------------------
# fake tensors on the meta device, of the dry run's one fake mode, as it
# traces them; every call below runs inside that mode
def _fake_mode():
    from repro_torch.launch.dryrun import fake_mode
    return fake_mode()


def _meta(t):
    return None if t is None else _fake_mode().from_tensor(t).to("meta")


def _same(got, want):
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple)
                                                               else (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "meta" and cost.shape_only(a)
        assert a.shape == b.shape and a.dtype == b.dtype


def _recorded(fn, fake=True):
    import contextlib
    with cost.recording() as rec, (_fake_mode() if fake else contextlib.nullcontext()):
        out = fn()
    return out, rec.kernels


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_epitome_matmul_shape_only(fused, dtype):
    from repro_torch.core.epitome import EpitomeSpec
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ops
    spec = EpitomeSpec(96, 80, 48, 64, 32, 32)
    g = torch.Generator().manual_seed(0)
    E = torch.randn(spec.m, spec.n, generator=g)
    x = torch.randn(2, 5, spec.M, generator=g).to(dtype)
    p = ops.pack_epitome(E, spec, QuantConfig(bits=3))
    plain, none = _recorded(lambda: ops.quant_epitome_matmul(x, None, spec, packed=p,
                                                             fused_fold=fused), False)
    assert none == {}            # a real CPU tensor runs the plain version
    pm = ops.PackedEpitome(_meta(p.q), _meta(p.scales), _meta(p.zeros), p.bk, p.bn)
    got, rec = _recorded(lambda: ops.quant_epitome_matmul(_meta(x), None, spec, packed=pm,
                                                          fused_fold=fused))
    _same(got, plain)
    name = "quant_epitome_matmul_fused_fold" if fused else "quant_epitome_matmul_blocks"
    assert list(rec) == [name] and rec[name]["launches"] == 1
    cb = ops.kernel_col_blocks(spec, p.bn)
    if not fused:
        nbytes, flops = cost.quant_epitome_work(10, spec.m, spec.n, len(cb), p.bn,
                                                len(set(cb.tolist())), p.scales.numel(),
                                                x.element_size())
        assert (rec[name]["bytes"], rec[name]["flops"]) == (nbytes, flops)


def test_epitome_matmul_and_quant_matmul_shape_only():
    from repro_torch.core.epitome import EpitomeSpec
    from repro_torch.kernels import ops
    spec = EpitomeSpec(96, 80, 48, 64, 32, 32)
    g = torch.Generator().manual_seed(0)
    E, x = torch.randn(spec.m, spec.n, generator=g), torch.randn(3, spec.M, generator=g)
    plain, none = _recorded(lambda: ops.epitome_matmul(x, E, spec), False)
    got, rec = _recorded(lambda: ops.epitome_matmul(_meta(x), _meta(E), spec))
    assert none == {}
    _same(got, plain)
    assert rec["epitome_matmul_blocks"]["launches"] == 1
    q = torch.randint(-128, 127, (256, 512), dtype=torch.int8, generator=g)
    s, z = torch.rand(1, 2, generator=g), torch.zeros(1, 2)
    xq = torch.randn(2, 3, 256, generator=g).bfloat16()
    plain, none = _recorded(lambda: ops.quant_matmul(xq, q, s, z), False)
    got, rec = _recorded(lambda: ops.quant_matmul(*map(_meta, (xq, q, s, z))))
    assert none == {}
    _same(got, plain)
    assert rec["quant_matmul"] == dict(
        launches=1, flops=2.0 * 6 * 256 * 512, bytes=cost.quant_matmul_work(6, 256, 512, 2, 2)[0],
        bound_s=cost.bound_seconds("quant_matmul",
                                   *cost.quant_matmul_work(6, 256, 512, 2, 2))[0])


@pytest.mark.parametrize("h0", [False, True])
def test_wkv6_and_its_gradient_shape_only(h0):
    from repro_torch.kernels import ops
    B, S, H, K = 2, 9, 2, 4
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(s, generator=g)
    ins = [f(B, S, H, K).bfloat16(), f(B, S, H, K).bfloat16(), f(B, S, H, K).bfloat16(),
           -torch.exp(f(B, S, H, K)), f(H, K), f(B, H, K, K) if h0 else None]
    plain, none = _recorded(lambda: ops.wkv6(*ins, chunk=4), False)
    assert none == {}
    with _fake_mode():
        meta = [None if t is None else _meta(t).requires_grad_(True) for t in ins]
    got, rec = _recorded(lambda: ops.wkv6(*meta, chunk=4))
    _same(got, plain)
    assert rec["wkv6_chunked"]["launches"] == 1
    flops, products = cost.wkv6_ops(B, S, H, K, 4)
    assert rec["wkv6_chunked"]["flops"] == flops
    _, rec = _recorded(lambda: torch.autograd.grad(
        got[0].sum() + got[1].sum(), [t for t in meta if t is not None]))
    assert rec["wkv6_chunked_bwd"]["launches"] == 1
    assert rec["wkv6_chunked_bwd"]["flops"] == cost.wkv_bwd_ops(B, S, H, K)


def test_mamba_scan_and_its_gradient_shape_only():
    from repro_torch.kernels import ops
    B, S, di, ds = 2, 5, 8, 4
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(s, generator=g)
    ins = [torch.rand(B, S, di, generator=g), f(B, S, di), f(B, S, ds), f(B, S, ds),
           -torch.rand(di, ds, generator=g), f(di), f(B, di, ds)]
    plain, none = _recorded(lambda: ops.mamba_scan(*ins), False)
    assert none == {}
    with _fake_mode():
        meta = [_meta(t).requires_grad_(True) for t in ins]
    got, rec = _recorded(lambda: ops.mamba_scan(*meta))
    _same(got, plain)
    assert rec["mamba_scan"]["flops"] == cost.scan_ops(B, S, di, ds)
    grads, rec = _recorded(lambda: torch.autograd.grad(got[0].sum() + got[1].sum(), meta))
    assert list(rec) == ["mamba_scan_bwd"] and rec["mamba_scan_bwd"]["launches"] == 1
    for gr, t in zip(grads, ins):
        assert gr.shape == t.shape and gr.device.type == "meta"


def test_a_real_tensor_never_takes_the_shape_only_branch():
    """Only a fake tensor does, whatever device it fakes; a plain meta
    tensor is refused by the kernels as before (tests/test_torch_wkv6.py)."""
    assert not cost.shape_only(torch.zeros(1))
    assert not cost.shape_only(torch.zeros(1, device="meta"))
    assert not cost.shape_only(torch.nn.Parameter(torch.zeros(1)))
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = torch.zeros(1)
    assert fake.device.type == "cpu" and cost.shape_only(fake)
    assert cost.shape_only(_meta(torch.zeros(1)))


def test_model_flops_is_six_n_d_for_training():
    cfg, cell = tconfigs.get_config("qwen2-72b"), tconfigs.SHAPES["train_4k"]
    n = cfg.param_count(active_only=True)
    assert troof.model_flops(cfg, cell) == 6.0 * n * cell.global_batch * cell.seq_len
    assert math.isclose(n, 72.7e9, rel_tol=1e-2)
    moe = tconfigs.get_config("phi3.5-moe-42b-a6.6b")
    assert moe.param_count(active_only=True) < moe.param_count() / 4
    assert np.isfinite(troof.analytic_hbm_bytes(moe, cell, 256, 4))
