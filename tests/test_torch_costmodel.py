"""Port parity for the measured cost model (``repro_torch.pim.costmodel``
against ``repro.pim.costmodel``): the cases of the reference's
``tests/test_costmodel.py`` on the port — per-layer weight_bits keying,
memoization (one timing per unique key), the cache shared with the
autotuner, degradation on a dead clock, batched priming, the measured
evolution search and its provenance — with injected timers on the CPU; a
measured search and legalization that write the same plan JSON, byte for
byte, in both packages; and the tiny calibration refit on the host.

The reference's ``MeasuredCost`` with a ``CountingTimer`` builds its runners
but never runs a kernel, so it runs here; the port's runners are built on
the CPU (``device="cpu"``)."""
import dataclasses
import json
import math

import numpy as np
import pytest

from repro.pim import costmodel as jcm
from repro.pim import plan as jplan
from repro.pim import simulator as jsim
from repro.pim.evo import EvoConfig as JEvo
from repro_torch.core.epitome import EpitomeSpec
from repro_torch.kernels import autotune
from repro_torch.launch import plan as plan_cli
from repro_torch.pim import simulator as tsim
from repro_torch.pim.costmodel import (AnalyticCost, MeasuredCost, cost_model_for,
                                       measured_cost_for)
from repro_torch.pim.evo import EvoConfig
from repro_torch.pim.plan import (auto_plan, inventory_for, legalize_plan, legalize_spec,
                                  search_plan, simulator_for, validate_plan_dict)
from repro_torch.pim.tables import TINY_CALIBRATION

ARCH = "tiny-resnet"
EVO = EvoConfig(population=8, iterations=3, seed=0)


class CountingTimer:
    """Deterministic fake clock: a fixed function of the call index; never
    runs the kernel."""

    def __init__(self):
        self.calls = 0

    def __call__(self, fn, iters):
        us = 100.0 + self.calls
        self.calls += 1
        return us


class FailingTimer:
    def __call__(self, fn, iters):
        raise RuntimeError("no clock on this host")


def _cm(tmp_path, timer=None, **kw):
    return measured_cost_for(ARCH, timer=timer or CountingTimer(),
                             cache_dir=str(tmp_path), device="cpu", **kw)


def _setup():
    return inventory_for(ARCH)(), auto_plan(ARCH, target_cr=2.0, weight_bits=3, mode="kernel")


def _entries(tmp_path):
    return autotune._load_cache(str(tmp_path), autotune.resolve_device("cpu"))


def _save(tmp_path, entries):
    autotune._save_cache(str(tmp_path), autotune.resolve_device("cpu"), entries)


# -- keys ----------------------------------------------------------------------------
def test_per_layer_bits_distinguish_keys(tmp_path):
    layers, plan = _setup()
    cm = _cm(tmp_path)
    other = dataclasses.replace(
        plan, layers=[dataclasses.replace(lp, weight_bits=5) if i == 2 else lp
                      for i, lp in enumerate(plan.layers)])
    k_a = [cm.layer_key(l, s, b) for l, s, b in zip(layers, plan.specs(), plan.bits())]
    k_b = [cm.layer_key(l, s, b) for l, s, b in zip(layers, other.specs(), other.bits())]
    assert k_a[2] != k_b[2] and "/b3/" in k_a[2] and "/b5/" in k_b[2]
    assert [k for i, k in enumerate(k_a) if i != 2] == [k for i, k in enumerate(k_b) if i != 2]


@pytest.mark.parametrize("t", [1, 2, 32])
def test_layer_keys_match_reference_on_heterogeneous_bits(tmp_path, t):
    """The same key as the reference's MeasuredCost for every layer of a
    plan whose layers carry different weight bits (dense layers included)."""
    layers, plan = _setup()
    jlayers, jplan_ = inventory_for(ARCH)(), jplan.auto_plan(ARCH, target_cr=2.0,
                                                              weight_bits=3, mode="kernel")
    bits = [None, 3, 5, 8, 3, 4, 2, 3, None][:len(layers)]
    specs = list(plan.specs())
    specs[1] = None                                  # a dense layer among them
    jspecs = list(jplan_.specs())
    jspecs[1] = None
    tcm = _cm(tmp_path, t=t)
    jc = jcm.measured_cost_for(ARCH, t=t, timer=CountingTimer(), cache_dir=str(tmp_path))
    got = [tcm.layer_key(l, s, b) for l, s, b in zip(layers, specs, bits)]
    want = [jc.layer_key(l, s, b) for l, s, b in zip(jlayers, jspecs, bits)]
    assert got == want
    assert [tcm._layer_T(l, None) for l in layers] == [jc._layer_T(l, None) for l in jlayers]


def test_key_is_on_the_legalized_spec(tmp_path):
    layers, _ = _setup()
    cm = _cm(tmp_path)
    l = next(x for x in layers if x.rows >= 16)
    a = EpitomeSpec(M=l.rows, N=l.cols, m=8, n=8, bm=8, bn=8)
    b = EpitomeSpec(M=l.rows, N=l.cols, m=9, n=8, bm=8, bn=8)
    la, _ = legalize_spec(l, a, cm.patch)
    lb, _ = legalize_spec(l, b, cm.patch)
    if la == lb:
        assert cm.layer_key(l, a, 3) == cm.layer_key(l, b, 3)
    assert cm.layer_key(l, a, 3) == autotune.tune_key(la, 3, cm._layer_T(l, None))


def test_dense_keys_and_conv_T(tmp_path):
    layers, _ = _setup()
    cm = _cm(tmp_path, t=2)
    k0, k3 = cm.layer_key(layers[0], None, None), cm.layer_key(layers[0], None, 3)
    assert k0.startswith("dense/") and k3.startswith("dense/") and k0 != k3
    conv = next(l for l in layers if l.kind == "conv")
    fc = next(l for l in layers if l.kind != "conv")
    assert cm._layer_T(conv, None) == 2 * conv.rounds and cm._layer_T(fc, None) == 2


# -- analytic ------------------------------------------------------------------------
def test_analytic_total_and_record():
    layers, plan = _setup()
    ac = AnalyticCost(simulator_for(ARCH))
    assert ac.total(layers, plan.specs(), plan.bits()) == pytest.approx(
        plan.predicted["latency_s"])
    rec = ac.plan_cost(plan).record()
    assert json.loads(json.dumps(rec)) == rec and rec["model"] == "analytic"
    assert rec["measured_s"] is None and all(l["measured_s"] is None for l in rec["layers"])


def test_cost_model_for_dispatch(tmp_path):
    assert cost_model_for(ARCH).name == "analytic"
    cm = cost_model_for(ARCH, "measured", cache_dir=str(tmp_path))
    assert isinstance(cm, MeasuredCost) and cm.name == "measured"
    with pytest.raises(ValueError):
        cost_model_for(ARCH, "vibes")


# -- memoization and the cache ---------------------------------------------------------
def test_duplicate_lookups_timed_once(tmp_path):
    _, plan = _setup()
    timer = CountingTimer()
    cm = _cm(tmp_path, timer=timer)
    c1 = cm.plan_cost(plan)
    n = timer.calls
    assert n == len({c.key for c in c1.layers}) == cm.timings
    c2 = cm.plan_cost(plan)
    assert timer.calls == n and c2.measured_s == pytest.approx(c1.measured_s)
    assert all(c.source == "memo" for c in c2.layers)


def test_cache_persists_across_instances(tmp_path):
    _, plan = _setup()
    _cm(tmp_path).plan_cost(plan)
    t2 = CountingTimer()
    cm2 = _cm(tmp_path, timer=t2)
    c = cm2.plan_cost(plan)
    assert t2.calls == cm2.timings == 0
    assert all(lc.source == "cache" for lc in c.layers)


def test_reuses_autotune_winner_without_retiming(tmp_path):
    layers, plan = _setup()
    cm = _cm(tmp_path)
    l, s = layers[0], plan.specs()[0]
    key = cm.layer_key(l, s, 3)
    entries = _entries(tmp_path)
    entries[key] = {"bt": 8, "bk": 8, "bn": 8, "fused_fold": False, "tuned_us": 42.0,
                    "heuristic_us": 50.0, "bit_identical": True, "max_err": 0.0,
                    "T": 8, "source": "timed"}
    _save(tmp_path, entries)
    costs = cm.layer_costs([l], [s], [3])
    assert costs[0].source == "cache" and costs[0].measured_s == pytest.approx(42.0e-6)
    assert cm.timings == 0


def test_tune_winner_feeds_the_cost_model(tmp_path):
    """A real legalize --tune sweep on the host fills the shared file, and
    the cost model reads its winner for the same key."""
    layers, plan = _setup()
    cm = _cm(tmp_path)
    l, s = layers[2], plan.specs()[2]
    res = autotune.tune(s, 3, cm._layer_T(l, None), grid="tiny", timer=CountingTimer(),
                        cache_dir=str(tmp_path), device="cpu")
    costs = cm.layer_costs([l], [s], [3])
    assert costs[0].key == res.key and costs[0].source == "cache"
    assert costs[0].measured_s == pytest.approx(res.tuned_us * 1e-6)


# -- robustness -------------------------------------------------------------------------
def test_failing_timer_degrades_with_warning(tmp_path):
    cm = _cm(tmp_path, timer=FailingTimer())
    with pytest.warns(UserWarning, match="degrading to analytic"):
        plan = search_plan(ARCH, objective="latency", weight_bits=3, evo=EVO, cost=cm,
                           measure_top_k=2)
    assert not cm.available
    gens = plan.provenance["measured_elites"]
    assert gens and all(not g["measured"] for g in gens)
    legal = legalize_plan(plan, cost=cm)
    assert legal.is_legalized() and legal.provenance["cost"]["measured_s"] is None
    validate_plan_dict(json.loads(legal.to_json()))


def test_degraded_matches_pure_analytic_search(tmp_path):
    cm = _cm(tmp_path, timer=FailingTimer())
    with pytest.warns(UserWarning):
        a = search_plan(ARCH, objective="latency", weight_bits=3, evo=EVO, cost=cm)
    b = search_plan(ARCH, objective="latency", weight_bits=3, evo=EVO)
    assert a.specs() == b.specs()
    assert a.provenance["best_curve"] == b.provenance["best_curve"]


@pytest.mark.parametrize("entry", [{"us": "not-a-number"}, {"us": float("nan")}, 3])
def test_corrupt_measure_entry_retimes(tmp_path, entry):
    _, plan = _setup()
    _cm(tmp_path).plan_cost(plan)
    _save(tmp_path, {k: entry for k in _entries(tmp_path)})
    t = CountingTimer()
    cm2 = _cm(tmp_path, timer=t)
    assert cm2.plan_cost(plan).measured_s is not None
    assert t.calls == cm2.timings > 0


def test_nonfinite_timer_degrades(tmp_path):
    _, plan = _setup()
    cm = _cm(tmp_path, timer=lambda fn, iters: float("nan"))
    with pytest.warns(UserWarning, match="degrading to analytic"):
        c = cm.plan_cost(plan)
    assert c.measured_s is None and not cm.available


def test_measured_requires_latency_objective(tmp_path):
    with pytest.raises(ValueError, match="latency"):
        search_plan(ARCH, objective="energy", weight_bits=3, evo=EVO, cost=_cm(tmp_path))


def test_default_device_is_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    layers, plan = _setup()
    cm = measured_cost_for(ARCH, timer=CountingTimer(), cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cm.plan_cost(plan)


# -- the measured search -----------------------------------------------------------------
def test_elites_timed_once_across_generations(tmp_path):
    timer = CountingTimer()
    cm = _cm(tmp_path, timer=timer)
    plan = search_plan(ARCH, objective="latency", weight_bits=3, evo=EVO, cost=cm,
                       measure_top_k=3)
    assert timer.calls == cm.timings and cm.lookups > cm.timings
    gens = plan.provenance["measured_elites"]
    assert len(gens) == EVO.iterations and all(g["measured"] for g in gens)
    assert all(e["measured_s"] is not None for g in gens for e in g["elites"])


def test_winner_is_measured_best_elite(tmp_path):
    plan = search_plan(ARCH, objective="latency", weight_bits=3, evo=EVO,
                       cost=_cm(tmp_path), measure_top_k=3)
    won = plan.provenance["cost"]["measured_s"]
    best_logged = min(e["measured_s"] for g in plan.provenance["measured_elites"]
                      for e in g["elites"])
    assert won <= best_logged * 1.5 + 1e-3


@pytest.mark.parametrize("top_k,act_bits", [(4, 9), (2, None)])
def test_measured_search_writes_the_reference_plan(tmp_path, top_k, act_bits):
    """The acceptance contract: with the same deterministic timer, the
    port's measured search and its legalization write the reference's plan
    JSON byte for byte (specs, cost, measured_elites, the sources)."""
    kw = dict(objective="latency", weight_bits=3, act_bits=act_bits, measure_top_k=top_k)
    tc = _cm(tmp_path / "port")
    jc = jcm.measured_cost_for(ARCH, timer=CountingTimer(), cache_dir=str(tmp_path / "ref"))
    a = search_plan(ARCH, evo=EVO, cost=tc, **kw)
    b = jplan.search_plan(ARCH, evo=JEvo(population=8, iterations=3, seed=0), cost=jc, **kw)
    assert a.to_json() == b.to_json()
    assert "measured_elites" in a.provenance and a.provenance["cost"]["model"] == "measured"
    la, lb = legalize_plan(a, cost=tc), jplan.legalize_plan(b, cost=jc)
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    la.save(pa)
    lb.save(pb)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    assert (tc.timings, tc.lookups) == (jc.timings, jc.lookups)


# -- prime -----------------------------------------------------------------------------
def test_prime_then_scoring_hits_memo(tmp_path):
    layers, plan = _setup()
    timer = CountingTimer()
    cm = _cm(tmp_path, timer=timer)
    n = cm.prime(layers, [plan.specs()], plan.bits())
    assert n >= 1 and timer.calls == n == cm.timings
    c = cm.plan_cost(plan)
    assert timer.calls == n and c.measured_s is not None
    assert all(lc.source == "memo" for lc in c.layers)
    assert n <= len({lc.key for lc in c.layers})


def test_prime_groups_same_shaped_runners(tmp_path):
    """The b3/b5 variants of one dense geometry: two keys, one timing of a
    callable that runs both runners, each billed half."""
    layers, _ = _setup()
    l = layers[0]
    ran = []

    def timer(fn, iters):
        ran.append(len(fn()))
        return 100.0

    cm = _cm(tmp_path, timer=timer)
    assert cm.prime([l, l], [[None, None]], [3, 5]) == 1 and ran == [2]
    costs = cm.layer_costs([l, l], [None, None], [3, 5])
    assert costs[0].key != costs[1].key and len(ran) == 1
    assert costs[0].measured_s == costs[1].measured_s == pytest.approx(50.0e-6)


def test_prime_skips_known_keys_and_persists(tmp_path):
    layers, plan = _setup()
    cm = _cm(tmp_path)
    cm.plan_cost(plan)
    assert cm.prime(layers, [plan.specs()], plan.bits()) == 0
    t2 = CountingTimer()
    cm2 = _cm(tmp_path / "b", timer=t2)
    assert cm2.prime(layers, [plan.specs()], plan.bits()) >= 1
    t3 = CountingTimer()
    c = _cm(tmp_path / "b", timer=t3).plan_cost(plan)
    assert t3.calls == 0 and all(lc.source == "cache" for lc in c.layers)


def test_prime_failing_timer_degrades(tmp_path):
    layers, plan = _setup()
    cm = _cm(tmp_path, timer=FailingTimer())
    with pytest.warns(UserWarning, match="degrading to analytic"):
        assert cm.prime(layers, [plan.specs()], plan.bits()) == 0
    assert not cm.available and cm.prime(layers, [plan.specs()], plan.bits()) == 0


# -- provenance and the command line ------------------------------------------------------
def test_measured_plan_round_trips_and_validates(tmp_path):
    cm = _cm(tmp_path)
    plan = legalize_plan(search_plan(ARCH, objective="latency", weight_bits=3, evo=EVO,
                                     cost=cm, measure_top_k=2), cost=cm)
    path = str(tmp_path / "plan.json")
    plan.save(path)
    with open(path) as f:
        d = json.load(f)
    validate_plan_dict(d)
    rec = d["provenance"]["cost"]
    assert rec["model"] == "measured" and rec["measured_s"] is not None
    assert jplan.EpitomePlan.load(path).to_json() == plan.to_json()


def test_show_prints_cost_and_tuned_columns(tmp_path, capsys):
    cm = _cm(tmp_path)
    plan = legalize_plan(auto_plan(ARCH, target_cr=2.0, weight_bits=3, mode="kernel"),
                         cost=cm)
    plan = autotune.tune_plan(plan, t=1, timer=CountingTimer(), cache_dir=str(tmp_path),
                              device="cpu")
    path = str(tmp_path / "plan.json")
    plan.save(path)
    plan_cli.main(["show", "--plan", path])
    out = capsys.readouterr().out
    assert "pred_ms" in out and "meas_ms" in out and "cost (measured" in out
    assert "tuned" in out and "/time" in out


# -- the tiny calibration ------------------------------------------------------------------
def test_calibration_system_is_the_reference_simulators():
    plan = auto_plan(ARCH, target_cr=2.0, weight_bits=3, mode="kernel")
    jp = jplan.auto_plan(ARCH, target_cr=2.0, weight_bits=3, mode="kernel")
    sim = jsim.PimSimulator(jsim.MappingConfig(xb_rows=8, xb_cols=8))
    layers = jplan.inventory_for(ARCH)()
    d = jsim._sums(sim.counters(layers))
    e = jsim._sums(sim.counters(layers, jp.specs(), jp.bits(), wrapping=True, act_bits=9))
    np.testing.assert_array_equal(tsim.tiny_calibration_system(plan),
                                  np.array([[d[0], d[1]], [e[0], e[1]]]))


def test_calibrate_tiny_coefficients_on_the_host():
    cal = tsim.calibrate_tiny_coefficients(iters=1, device="cpu")
    assert math.isfinite(cal.A) and math.isfinite(cal.B) and min(cal.A, cal.B) >= 0
    assert cal.measured_dense_s > 0 and cal.measured_epitome_s > 0
    assert (cal.batch, cal.hw) == (2, 16)
    # a fit is returned, never stored: the plans keep the reference's constants
    assert (TINY_CALIBRATION.A, TINY_CALIBRATION.B) == (5.3825e-07, 0.0)
