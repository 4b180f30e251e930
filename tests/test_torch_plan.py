"""Port parity for the plan stack (core/placement, pim/{xbar,tables,
simulator,costmodel,evo,plan}, the registry's plan entry points, the plan
CLI): the same inputs give the same simulator costs, the same searched
plans, the same legalized plans and the same JSON, field for field, as
``repro.pim``; plans cross between the packages through JSON; a searched
plan runs to the reference's logits and tokens.

Integer and static artifacts match exactly (plan JSON included); logits
within the ResNet and LM parity tolerances of ``test_torch_resnet.py`` and
``test_torch_lm.py``.  The reference's kernel modes run its Pallas kernels
in interpret mode under the ``pallas_compat`` alias (jax 0.9 renamed
``pltpu.TPUCompilerParams``), set for one test at a time."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_resnet as jget_resnet
from repro.configs import get_smoke_config as jget_smoke
from repro.core import placement as jplacement
from repro.models import lm as jlm
from repro.pim import plan as jplan
from repro.pim import xbar as jxbar
from repro.pim.evo import EvoConfig as JEvo
from repro.pim.simulator import default_calibrated_simulator as jdefault_sim
from repro_torch.configs import get_config, get_resnet, get_smoke_config
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.core import placement as tplacement
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import launch_counts
from repro_torch.kernels.ops import pack_blocks
from repro_torch.launch import plan as plan_cli
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.pim import plan as tplan
from repro_torch.pim import xbar as txbar
from repro_torch.pim.costmodel import MeasuredCost, cost_model_for
from repro_torch.pim.evo import EvoConfig as TEvo
from repro_torch.pim.simulator import default_calibrated_simulator as tdefault_sim


@pytest.fixture
def pallas_compat(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    yield
    jax.clear_caches()


def _specs_equal(a, b):
    assert [None if s is None else dataclasses.astuple(s) for s in a] == \
        [None if s is None else dataclasses.astuple(s) for s in b]


def _json_equal(port_plan, ref_plan):
    """Field for field: the dicts equal, and their JSON (float reprs
    included) byte for byte."""
    assert port_plan.to_dict() == ref_plan.to_dict()
    assert port_plan.to_json() == ref_plan.to_json()


# -- simulator ------------------------------------------------------------------
def test_calibrated_coefficients_equal():
    assert dataclasses.asdict(tdefault_sim().coeff) == dataclasses.asdict(jdefault_sim().coeff)


@pytest.mark.parametrize("arch", ["resnet50", "resnet101"])
@pytest.mark.parametrize("design", ["dense", "uniform-1024x256", "auto_plan"])
def test_simulator_summaries_equal(arch, design):
    tsim, jsim = tplan.simulator_for(arch), jplan.simulator_for(arch)
    tl, jl = tplan.inventory_for(arch)(), jplan.inventory_for(arch)()
    assert [dataclasses.astuple(l) for l in tl] == [dataclasses.astuple(l) for l in jl]
    if design == "dense":
        ts, js, bits = None, None, None
    elif design == "uniform-1024x256":
        ts = txbar.uniform_epitome_specs(tl, 1024, 256, tsim.mapping)
        js = jxbar.uniform_epitome_specs(jl, 1024, 256, jsim.mapping)
        bits = None
    else:
        ts = tplan.auto_plan(arch, weight_bits=3).specs()
        js = jplan.auto_plan(arch, weight_bits=3).specs()
        bits = [3] * len(tl)
    if ts is not None:
        _specs_equal(ts, js)
    for wrapping, act_bits in ((False, None), (True, 9)):
        a = tsim.simulate(tl, ts, bits, wrapping=wrapping, act_bits=act_bits)
        b = jsim.simulate(jl, js, bits, wrapping=wrapping, act_bits=act_bits)
        assert a.summary() == b.summary()
        assert [dataclasses.astuple(c) for c in a.layers] == \
            [dataclasses.astuple(c) for c in b.layers]


# -- search and legalization --------------------------------------------------------
SEARCHES = [
    ("resnet50", "latency", 3, (16, 8, 0)),
    ("resnet50", "energy", 3, (16, 8, 0)),
    ("resnet50", "edp", 3, (16, 8, 0)),
    ("tiny-resnet", "latency", 3, (10, 5, 1)),
    ("rwkv6-7b-smoke", "latency", 3, (16, 8, 0)),
    ("resnet50", "latency", 3, (24, 12, 0)),     # best_curve moves
    ("resnet50", "edp", None, (16, 8, 2)),        # fp weights
]


def _search(arch, objective, bits, evo):
    pop, iters, seed = evo
    kw = dict(objective=objective, weight_bits=bits, act_bits=9 if bits else None)
    a = tplan.search_plan(arch, evo=TEvo(population=pop, iterations=iters, seed=seed), **kw)
    b = jplan.search_plan(arch, evo=JEvo(population=pop, iterations=iters, seed=seed), **kw)
    return a, b


@pytest.mark.parametrize("arch,objective,bits,evo", SEARCHES,
                         ids=[f"{a}-{o}-q{b}-{e[0]}x{e[1]}s{e[2]}" for a, o, b, e in SEARCHES])
def test_search_and_legalize_equal_reference(arch, objective, bits, evo):
    a, b = _search(arch, objective, bits, evo)
    _json_equal(a, b)
    if evo == (24, 12, 0):
        curve = a.provenance["best_curve"]
        assert curve[-1] > curve[0] and curve == sorted(curve)
    _json_equal(tplan.legalize_plan(a), jplan.legalize_plan(b))


def test_legalize_with_mesh_and_patch_equal_reference():
    a, b = _search("rwkv6-7b-smoke", "energy", 3, (12, 4, 3))
    mesh = {"data": 2, "model": 4}
    _json_equal(tplan.legalize_plan(a, mesh_shape=mesh, patch=(16, 16)),
                jplan.legalize_plan(b, mesh_shape=mesh, patch=(16, 16)))


def test_other_planners_equal_reference():
    _json_equal(tplan.uniform_plan("resnet50", weight_bits=3, act_bits=9),
                jplan.uniform_plan("resnet50", weight_bits=3, act_bits=9))
    _json_equal(tplan.auto_plan("tiny-resnet", weight_bits=3),
                jplan.auto_plan("tiny-resnet", weight_bits=3))
    _json_equal(tplan.auto_plan("rwkv6-7b-smoke", weight_bits=3),
                jplan.auto_plan("rwkv6-7b-smoke", weight_bits=3))


def test_evo_variant_plan_equal_reference():
    """The plan behind get_resnet("resnet50", "evo-latency-q3"): 38
    epitomized layers, all kernel mode at 3 bits."""
    from repro.configs.registry import _evo_variant as jevo
    from repro_torch.configs.registry import _evo_variant as tevo
    a, b = tevo("resnet50", "evo-latency-q3"), jevo("resnet50", "evo-latency-q3")
    _json_equal(a, b)
    assert a.n_epitomized == 38 and set(a.bits()) == {3}
    assert a.uniform_mode() == "kernel"


# -- JSON across the packages ---------------------------------------------------------
def _layer_config_fields(configs):
    out = []
    for name, lc in configs:
        out.append((name, None if lc.spec is None else dataclasses.astuple(lc.spec),
                    lc.mode, None if lc.quant is None else dataclasses.asdict(lc.quant),
                    None if lc.placement is None else lc.placement.to_dict(),
                    lc.blocks, lc.fused_fold))
    return out


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_plan_json_crosses_packages(tmp_path, writer):
    a, b = _search("tiny-resnet", "latency", 3, (10, 5, 4))
    a, b = tplan.legalize_plan(a), jplan.legalize_plan(b)
    tuned = {lp.name: {"bt": 64, "bk": 8, "bn": lp.spec.bn, "fused_fold": i % 2 == 0}
             for i, lp in enumerate(a.layers) if lp.spec is not None}
    shard = {"row_axis": "data", "col_axis": "model", "scales": "shard"}
    for p, pl in ((a, tplacement), (b, jplacement)):
        p.provenance["tuned_blocks"] = tuned
        p.layers[1] = dataclasses.replace(p.layers[1],
                                          placement=pl.LayerPlacement.from_dict(shard))
    path = tmp_path / "plan.json"
    (a if writer == "port" else b).save(str(path))
    ta, jb = tplan.EpitomePlan.load(str(path)), jplan.EpitomePlan.load(str(path))
    assert ta.to_dict() == jb.to_dict() == json.loads(path.read_text())
    assert ta.tuned_blocks() == jb.tuned_blocks() and len(ta.tuned_blocks()) == ta.n_epitomized
    fields = _layer_config_fields(ta.layer_configs())
    assert fields == _layer_config_fields(jb.layer_configs())
    assert fields[1][4] == shard
    assert any(f[6] for f in fields) and any(f[5] is not None for f in fields)


def test_load_rejects_layer_name_drift():
    d = tplan.legalize_plan(_search("tiny-resnet", "latency", 3, (10, 5, 4))[0]).to_dict()
    d["layers"][0]["name"] = "conv0"
    with pytest.raises(tplan.PlanSchemaError, match="drifted"):
        tplan.EpitomePlan.from_dict(d)


_MUTATIONS = {
    "version": lambda d: d.update(version=99),
    "arch": lambda d: d.update(arch="resnet9000"),
    "extra_key": lambda d: d.update(extra_key=1),
    "no_provenance": lambda d: d.pop("provenance"),
    "mode": lambda d: d["layers"][0].update(mode="warp-drive"),
    "weight_bits": lambda d: d["layers"][0].update(weight_bits=99),
    "no_snap_err": lambda d: d["layers"][0].pop("snap_err"),
    "spec_m": lambda d: d["layers"][2]["spec"].update(m=10**9),
    "spec_no_bn": lambda d: d["layers"][2]["spec"].pop("bn"),
    "row_axis": lambda d: d["layers"][0]["placement"].update(row_axis="weird"),
    "col_axis": lambda d: d["layers"][0]["placement"].update(col_axis="xbar0"),
    "same_axis": lambda d: d["layers"][0]["placement"].update(row_axis="model",
                                                              col_axis="model"),
    "scales": lambda d: d["layers"][0]["placement"].update(scales="maybe"),
    "no_scales": lambda d: d["layers"][0]["placement"].pop("scales"),
    "no_placement_key": lambda d: d["layers"][0].pop("placement"),
    "kernel_without_placement": lambda d: d["layers"][next(
        i for i, r in enumerate(d["layers"])
        if r["spec"] is not None and r["mode"] == "kernel")].update(placement=None),
}


@pytest.mark.parametrize("mutation", list(_MUTATIONS))
def test_schema_rejects_drift(mutation):
    """``tests/test_plan.py::test_schema_rejects_drift``, case by case, in
    both packages."""
    d = tplan.legalize_plan(_search("tiny-resnet", "latency", 3, (10, 5, 4))[0]).to_dict()
    tplan.validate_plan_dict(d)
    bad = json.loads(json.dumps(d))
    _MUTATIONS[mutation](bad)
    with pytest.raises(tplan.PlanSchemaError):
        tplan.validate_plan_dict(bad)
    with pytest.raises(jplan.PlanSchemaError):
        jplan.validate_plan_dict(bad)


# -- placement ----------------------------------------------------------------------
NAMES = ["L0/mixer/wq", "L0/mixer/wo", "L0/ffn/w_down", "L0/ffn/wk", "L0/ffn/wv",
         "layer1.0.conv2", "fc"]


def test_placement_roles_defaults_and_snaps_equal_reference():
    for name in NAMES:
        assert tplacement.placement_role(name) == jplacement.placement_role(name)
        assert tplacement.default_placement(name).to_dict() == \
            jplacement.default_placement(name).to_dict()
    cases = [(dict(row_axis="data", col_axis="model"), 96, 24, {"data": 3, "model": 5}, None),
             (dict(row_axis="data", col_axis="model"), 96, 24, {"model": 4}, None),
             (dict(col_axis="model", scales="shard"), 32, 96, {"model": 4}, (1, 3)),
             (dict(col_axis="model", scales="shard"), 32, 96, {"model": 3}, (1, 3))]
    for kw, rows, cols, mesh, grid in cases:
        a, fa = tplacement.snap_placement(tplacement.LayerPlacement(**kw), rows, cols,
                                          mesh, scale_grid=grid)
        b, fb = jplacement.snap_placement(jplacement.LayerPlacement(**kw), rows, cols,
                                          mesh, scale_grid=grid)
        assert a.to_dict() == b.to_dict() and fa == fb
    with pytest.raises(ValueError, match="only one dim"):
        tplacement.LayerPlacement(row_axis="model", col_axis="model")


def test_pack_grid_matches_kernel_pack_blocks():
    from repro_torch.core.epitome import EpitomeSpec
    for spec in (EpitomeSpec(M=64, N=96, m=32, n=96, bm=32, bn=32),
                 EpitomeSpec(M=144, N=64, m=96, n=8, bm=8, bn=8),
                 EpitomeSpec(M=576, N=64, m=288, n=64, bm=128, bn=64)):
        for tile in (256, 32):
            bk, bn = pack_blocks(spec, QuantConfig(bits=3, tile=tile))
            assert tplan.pack_grid(spec, tile) == (-(-spec.m // bk), -(-spec.n // bn))


# -- the registry, the model and the CLI ------------------------------------------------
IMAGES = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(np.float32)


def test_tiny_resnet_evo_plan_forward_matches_reference(pallas_compat):
    """get_resnet("tiny-resnet", "evo-latency-q3") in both packages: the
    same specs and bits, the reference's parameters carried across and
    prepacked by both, logits within 1e-4 * max(1, max|ref|)."""
    jm = jget_resnet("tiny-resnet", "evo-latency-q3")
    tm = get_resnet("tiny-resnet", "evo-latency-q3", device="cpu")
    _specs_equal(tm.specs, jm.specs)
    assert tm.layer_bits == jm.layer_bits and tm.mode == jm.mode == "kernel"
    jp = jm.init(jax.random.PRNGKey(0))
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")).prepack()
    want = np.asarray(jm.apply(jm.prepack(jp), IMAGES))
    before = launch_counts()
    with torch.no_grad():
        y = tm.apply(torch.from_numpy(IMAGES)).numpy()
    assert launch_counts() == before
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_registry_plan_kwarg_and_fused_fold_provenance(tmp_path):
    plan = tplan.legalize_plan(_search("tiny-resnet", "latency", 3, (10, 5, 0))[0])
    path = tmp_path / "p.json"
    plan.save(str(path))
    m = get_resnet("tiny-resnet", plan=str(path), device="cpu")
    assert m.specs == plan.specs() and m.layer_bits == [3] * len(plan.layers)
    with pytest.raises(ValueError, match="plan is for"):
        get_resnet("resnet50", plan=str(path), device="cpu")
    plan.provenance["tuned_blocks"] = {
        lp.name: {"bt": 8, "bk": pack_blocks(lp.spec, QuantConfig(bits=3))[0],
                  "bn": lp.spec.bn, "fused_fold": True}
        for lp in plan.layers if lp.spec is not None}
    fused = get_resnet("tiny-resnet", plan=plan, device="cpu")
    assert all(c.fused_fold for n, c in fused.cfgs.items() if c.spec is not None)
    fused.load_params(m.init().params()).prepack()
    with torch.no_grad():
        x = torch.from_numpy(IMAGES)
        want = m.prepack().apply(x).numpy()
        np.testing.assert_allclose(fused.apply(x).numpy(), want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))


def test_unlegalized_lm_plan_refused():
    plan = tplan.search_plan("rwkv6-7b-smoke", weight_bits=3,
                             evo=TEvo(population=8, iterations=2, seed=0))
    plan.layers[0] = dataclasses.replace(
        plan.layers[0], spec=dataclasses.replace(plan.layers[0].spec, n=24, bn=8))
    with pytest.raises(ValueError, match="not kernel-exact"):
        get_smoke_config("rwkv6-7b", plan=plan)
    with pytest.raises(ValueError, match="plan is for"):
        get_config("rwkv6-7b", plan=plan)
    measured = cost_model_for("rwkv6-7b", "measured")
    assert isinstance(measured, MeasuredCost) and measured.name == "measured"


def test_rwkv6_smoke_plan_matches_reference(pallas_compat):
    """An rwkv6-7b smoke config built with plan=: prefill logits and greedy
    tokens of the reference, with its parameters carried across (float32,
    the LM parity tolerance 1e-4 of the logits' scale)."""
    a, b = _search("rwkv6-7b-smoke", "latency", 3, (16, 8, 0))
    a, b = tplan.legalize_plan(a), jplan.legalize_plan(b)
    tc = dataclasses.replace(get_smoke_config("rwkv6-7b", "off", plan=a),
                             compute_dtype="float32")
    jc = dataclasses.replace(jget_smoke("rwkv6-7b", "off", plan=b), compute_dtype="float32")
    assert _layer_config_fields(tc.layer_config) == _layer_config_fields(jc.layer_config)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), jc))
    jp = jlm.prepack_params(jax.tree.map(jnp.asarray, tree), jc)
    tp = lm.prepack_params(lm_params_from_jax(tree, tc, "cpu"), tc)
    prompts = np.random.default_rng(1).integers(0, tc.vocab, (2, 24)).astype(np.int32)
    jl, _ = jlm.prefill(jp, jnp.asarray(prompts), jlm.init_decode_state(jc, 2, 40), jc)
    with torch.no_grad():
        tl, _ = lm.prefill(tp, torch.from_numpy(prompts), lm.init_decode_state(tc, 2, 40, "cpu"), tc)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * max(1.0, np.abs(jl).max()))
    from repro.launch import serve as jserve
    jt, _ = jserve.generate(jp, jc, jnp.asarray(prompts), 40, 5)
    tt, _ = serve.generate(tp, tc, torch.from_numpy(prompts), 40, 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_plan_cli_on_cpu(tmp_path, capsys):
    out, legal = str(tmp_path / "plan.json"), str(tmp_path / "plan_legal.json")
    plan_cli.main(["search", "--arch", "tiny-resnet", "--weight-bits", "3", "--act-bits", "9",
                   "--population", "8", "--iterations", "3", "--out", out])
    plan_cli.main(["legalize", "--plan", out, "--out", legal])
    plan_cli.main(["show", "--plan", legal])
    plan_cli.main(["run", "--plan", legal, "--device", "cpu", "--iters", "1"])
    text = capsys.readouterr().out
    assert "NOT legalized" in text and "legalized tiny-resnet" in text
    assert "layer1.0.conv2" in text and "specs identical to the plan: True" in text
    assert "predicted (PIM simulator)" in text and "not a device time" in text
    assert "logits (2, 10) finite: True" in text
    # the reference loads what the port's CLI wrote
    assert jplan.EpitomePlan.load(legal).to_dict() == tplan.EpitomePlan.load(legal).to_dict()
    with pytest.raises(SystemExit, match="not legalized"):
        plan_cli.main(["run", "--plan", out, "--device", "cpu"])
    # an LM smoke plan: run it, and serve it
    lm_out, lm_legal = str(tmp_path / "lm.json"), str(tmp_path / "lm_legal.json")
    plan_cli.main(["search", "--arch", "rwkv6-7b-smoke", "--weight-bits", "3",
                   "--population", "8", "--iterations", "2", "--out", lm_out])
    plan_cli.main(["legalize", "--plan", lm_out, "--out", lm_legal])
    plan_cli.main(["run", "--plan", lm_legal, "--device", "cpu", "--iters", "1"])
    toks = serve.main(["--arch", "rwkv6-7b", "--smoke", "--plan", lm_legal, "--device", "cpu",
                       "--requests", "2", "--prompt-len", "8", "--max-new-tokens", "3"])
    text = capsys.readouterr().out
    assert "8/8 projections epitomized" in text and "tok/s" in text
    assert f"epitome={lm_legal} (prepacked)" in text and tuple(toks.shape) == (2, 3)
    # measured search and tuned legalization on the host, into a cache of
    # their own; --mesh stays refused for a ResNet plan
    cache, measured, tuned = (str(tmp_path / n) for n in ("tuned", "m.json", "t.json"))
    plan_cli.main(["search", "--arch", "tiny-resnet", "--weight-bits", "3", "--act-bits", "9",
                   "--population", "8", "--iterations", "2", "--measured", "--device", "cpu",
                   "--measure-cache", cache, "--out", measured])
    plan_cli.main(["legalize", "--plan", measured, "--tune", "--device", "cpu",
                   "--tune-cache", cache, "--out", tuned])
    plan_cli.main(["run", "--plan", tuned, "--device", "cpu", "--iters", "1"])
    text = capsys.readouterr().out
    assert "measured elites: 2/2 generations" in text and "degraded=False" in text
    # the host's clock ranks the elites, so which layers the plan
    # epitomizes is read from the plan, not fixed here
    blocks = tplan.EpitomePlan.load(tuned).tuned_blocks()
    assert blocks == jplan.EpitomePlan.load(tuned).tuned_blocks() != {}
    assert "(legalized; ready for" in text and f"[tune] {min(blocks)}:" in text
    assert f"tuned blocks honored for {len(blocks)} layer(s)" in text
    assert len(blocks) == tplan.EpitomePlan.load(measured).n_epitomized
    with pytest.raises(SystemExit, match="applies to LM plans"):
        plan_cli.main(["run", "--plan", legal, "--mesh", "2,4"])
