"""Port parity for the kernel autotuner (``repro_torch.kernels.autotune``
against ``repro.kernels.autotune``): the same keys, buckets, signatures and
candidate grids (the port's with the heuristic bt, since its kernels take
none); the cache's round trip, invalidation and corruption handling; the
tuner's contract (heuristic in the sweep, bit-identical winners, a dead
clock degrading to the heuristic, shape refusals skipped and launch errors
raised); and tuned plans whose JSON crosses between the packages byte for
byte and whose blocks reach the layer configs and serve.

Runs on the CPU with ``device="cpu"`` (the kernels' plain versions) and the
reference's deterministic ``CountingTimer``; the reference's ``tune`` is
never called here, as it runs Pallas in interpret mode."""
import dataclasses
import json
import math
import os
import time

import numpy as np
import pytest
import torch

from repro.core.epitome import EpitomeSpec as JSpec
from repro.kernels import autotune as jat
from repro.pim import plan as jplan
from repro_torch.configs import get_resnet
from repro_torch.core.epitome import EpitomeSpec
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import autotune, ops
from repro_torch.pim import plan as tplan
from repro_torch.pim.evo import EvoConfig

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

SPEC = EpitomeSpec(M=128, N=128, m=64, n=128, bm=32, bn=64)   # aligned
CPU = torch.device("cpu")
TINY = "tiny-resnet"


class CountingTimer:
    """Deterministic fake timer: latency is a fixed function of the call
    index, so winners don't depend on wall-clock noise and tests can assert
    how many timings ran."""

    def __init__(self, best_idx=None):
        self.calls = 0
        self.best_idx = best_idx

    def __call__(self, fn, iters):
        us = 100.0 + self.calls
        if self.best_idx is not None and self.calls == self.best_idx:
            us = 1.0
        self.calls += 1
        return us


def _tune(tmp, bits=3, T=8, **kw):
    kw.setdefault("timer", CountingTimer())
    kw.setdefault("grid", "tiny")
    return autotune.tune(SPEC, bits, T, cache_dir=str(tmp), device="cpu", **kw)


def _jspec(spec):
    return JSpec(**dataclasses.asdict(spec))


def _plan_specs():
    """Every epitomized spec of the tiny-resnet and resnet50 auto plans and
    of a searched tiny-resnet plan, plus SPEC."""
    specs = {SPEC}
    for arch in (TINY, "resnet50"):
        specs |= {s for s in tplan.auto_plan(arch, weight_bits=3).specs() if s is not None}
    searched = tplan.search_plan(TINY, weight_bits=3,
                                 evo=EvoConfig(population=8, iterations=2, seed=0))
    specs |= {s for s in tplan.legalize_plan(searched).specs() if s is not None}
    return sorted(specs, key=dataclasses.astuple)


# -- keys, buckets, grids ------------------------------------------------------------
@pytest.mark.parametrize("T", [1, 7, 8, 9, 49, 196, 256, 257, 1568, 401408])
def test_t_bucket_matches_reference(T):
    assert autotune.t_bucket(T) == jat.t_bucket(T)


def test_keys_and_signatures_match_reference():
    for spec in _plan_specs():
        assert autotune.spec_signature(spec) == jat.spec_signature(_jspec(spec))
        for bits in (0, 3, 8):
            for T in (1, 49, 196, 12544):
                assert autotune.tune_key(spec, bits, T) == jat.tune_key(_jspec(spec), bits, T)
    assert autotune.tune_key(SPEC, 3, 196) == autotune.tune_key(SPEC, 3, 256)
    assert autotune.tune_key(SPEC, 3, 196) != autotune.tune_key(SPEC, 4, 196)


def _projected(ref_cands):
    """The reference's grid with every bt set to the heuristic's: the first
    triple of each distinct (bk, bn), in the reference's order."""
    bt = ref_cands[0][0]
    out = []
    for _, bk, bn in ref_cands:
        if (bt, bk, bn) not in out:
            out.append((bt, bk, bn))
    return out


@pytest.mark.parametrize("grid", ["tiny", "default"])
@pytest.mark.parametrize("bits", [0, 3])
def test_candidates_are_the_reference_projected(grid, bits):
    for spec in _plan_specs():
        for T in (1, 8, 49, 196, 4096):
            want = _projected(jat.candidate_blocks(_jspec(spec), T, bits=bits, grid=grid))
            got = autotune.candidate_blocks(spec, T, bits=bits, grid=grid)
            assert got == want, (spec, T)


def test_candidates_heuristic_first():
    cands = autotune.candidate_blocks(SPEC, 8, bits=3, grid="tiny")
    assert cands[0] == (ops._pick_bt(8), ops._pick_bk_quant(SPEC.m, 256), SPEC.bn)
    assert len(set(cands)) == len(cands)
    assert len({c[0] for c in autotune.candidate_blocks(SPEC, 300, bits=3)}) == 1


# -- the cache -----------------------------------------------------------------------
def test_round_trip_hits_cache_and_launches_nothing(tmp_path, monkeypatch):
    timer = CountingTimer()
    r1 = _tune(tmp_path, timer=timer)
    assert r1.source == "timed" and timer.calls > 0
    n = timer.calls
    calls = []
    real = ops.quant_epitome_matmul
    monkeypatch.setattr(autotune.ops, "quant_epitome_matmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    r2 = _tune(tmp_path, timer=timer)
    assert r2.source == "cache" and timer.calls == n and not calls
    assert (r2.blocks, r2.fused_fold, r2.tuned_us) == (r1.blocks, r1.fused_fold, r1.tuned_us)
    # the port's own file only: never the reference's <backend>.json
    assert os.listdir(tmp_path) == ["torch-cpu.json"]
    with open(tmp_path / "torch-cpu.json") as f:
        d = json.load(f)
    assert set(d) == {"backend", "torch", "cuda", "device", "entries"}
    assert d["backend"] == "torch-cpu" and d["torch"] == torch.__version__
    assert d["entries"][r1.key] == r1.record()


def test_force_retunes(tmp_path):
    timer = CountingTimer()
    _tune(tmp_path, timer=timer)
    n = timer.calls
    r = _tune(tmp_path, timer=timer, force=True)
    assert r.source == "timed" and timer.calls > n


@pytest.mark.parametrize("field", ["backend", "torch", "cuda", "device"])
def test_stale_header_invalidates(tmp_path, field):
    _tune(tmp_path)
    path = autotune._cache_path(str(tmp_path), "torch-cpu")
    with open(path) as f:
        d = json.load(f)
    d[field] = "stale"
    with open(path, "w") as f:
        json.dump(d, f)
    assert autotune._load_cache(str(tmp_path), CPU) == {}
    assert _tune(tmp_path).source == "timed"        # re-tuned, no crash


@pytest.mark.parametrize("text", ["not json{", "[1, 2]", '{"entries": 3}'])
def test_corrupt_cache_falls_back(tmp_path, text):
    (tmp_path / "torch-cpu.json").write_text(text)
    assert autotune._load_cache(str(tmp_path), CPU) == {}
    assert _tune(tmp_path).source == "timed"


def test_corrupt_entry_retunes(tmp_path):
    r = _tune(tmp_path)
    entries = autotune._load_cache(str(tmp_path), CPU)
    entries[r.key] = {"bt": 8}                       # partial garbage
    autotune._save_cache(str(tmp_path), CPU, entries)
    assert _tune(tmp_path).source == "timed"


# -- the tuner -----------------------------------------------------------------------
def test_deterministic_winner(tmp_path):
    r1 = _tune(tmp_path / "a", timer=CountingTimer(2))
    r2 = _tune(tmp_path / "b", timer=CountingTimer(2))
    assert (r1.blocks, r1.fused_fold, r1.tuned_us) == (r2.blocks, r2.fused_fold, r2.tuned_us)


@pytest.mark.parametrize("best", [0, 1, 3])
def test_tuned_never_slower_than_heuristic(tmp_path, best):
    r = _tune(tmp_path, timer=CountingTimer(best), grid="default")
    assert r.tuned_us <= r.heuristic_us
    assert len(r.sweep) == 2 * len(autotune.candidate_blocks(SPEC, 8, bits=3))


@pytest.mark.parametrize("timer", [lambda fn, iters: float("nan"), "raise"])
def test_timer_failure_degrades_to_heuristic(tmp_path, timer):
    if timer == "raise":
        def timer(fn, iters):
            raise RuntimeError("no clock")
    r = _tune(tmp_path, timer=timer)
    assert r.source == "heuristic"
    assert r.blocks == autotune.candidate_blocks(SPEC, 8, bits=3, grid="tiny")[0]
    # nothing cached: a later run with a working timer re-tunes
    assert _tune(tmp_path).source == "timed"


def test_winner_bit_identical_and_accurate(tmp_path):
    """The default contract: the winning blocks give output bit-identical
    to the heuristic blocks', within 1e-4 of the reconstruct oracle."""
    for best in range(4):
        r = _tune(tmp_path / str(best), timer=CountingTimer(best))
        assert r.bit_identical and r.max_err <= 1e-4
        x, E = autotune._synthetic_case(SPEC, autotune.t_bucket(8), CPU)
        qcfg = QuantConfig(bits=3)
        y_h = ops.quant_epitome_matmul(x, None, SPEC, packed=ops.pack_epitome(E, SPEC, qcfg))
        y_t = ops.quant_epitome_matmul(x, None, SPEC, fused_fold=r.fused_fold,
                                       packed=ops.pack_epitome(E, SPEC, qcfg, blocks=r.blocks))
        assert torch.equal(y_h, y_t)
        assert all(s["max_err"] <= 1e-4 for s in r.sweep)


def test_open_grid_reports_error(tmp_path):
    r = _tune(tmp_path, timer=CountingTimer(3), grid="default", require_bit_identical=False)
    assert r.tuned_us == 1.0 and math.isfinite(r.max_err)


def test_fp_kernel_tunes_too(tmp_path):
    r = _tune(tmp_path, bits=0, T=16)
    assert r.source == "timed" and not r.fused_fold
    assert r.max_err <= 1e-4
    assert not any(s["fused_fold"] for s in r.sweep)


def test_record_is_json_native(tmp_path):
    rec = _tune(tmp_path).record()
    assert json.loads(json.dumps(rec)) == rec
    assert all(type(v) in (int, float, bool, str) for v in rec.values())
    assert set(rec) == {"bt", "bk", "bn", "fused_fold", "tuned_us", "heuristic_us",
                        "bit_identical", "max_err", "backend", "key"}


def test_shape_refusals_skipped_launch_errors_raised(tmp_path, monkeypatch):
    """Only a refusal before launch (ValueError) skips a candidate, and the
    result lists it; any other error propagates."""
    real = ops.quant_epitome_matmul

    def refuse_narrow(x, E, spec, qcfg=None, *, packed=None, fused_fold=False):
        if packed.bk != ops._pick_bk_quant(spec.m, 256):
            raise ValueError("refused")
        return real(x, E, spec, qcfg, packed=packed, fused_fold=fused_fold)

    monkeypatch.setattr(autotune.ops, "quant_epitome_matmul", refuse_narrow)
    r = _tune(tmp_path / "a")
    assert r.source == "timed" and len(r.skipped) == 2 and len(r.sweep) == 2

    def launch_fails(x, E, spec, qcfg=None, *, packed=None, fused_fold=False):
        if fused_fold:
            raise RuntimeError("kernel launch failed")
        return real(x, E, spec, qcfg, packed=packed, fused_fold=fused_fold)

    monkeypatch.setattr(autotune.ops, "quant_epitome_matmul", launch_fails)
    with pytest.raises(RuntimeError, match="launch failed"):
        _tune(tmp_path / "b")


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device would tune on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        autotune.tune(SPEC, 3, 8, cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        autotune.resolve_device("cuda")
    assert autotune.resolve_device("cpu") == CPU


def test_wall_timer_on_the_host():
    calls = []
    us = autotune.wall_timer(lambda: calls.append(1) or time.sleep(0.002), 3)
    assert len(calls) == 4 and 2000 <= us < 1e6       # warm-up + best of 3
    assert autotune.wall_timer(lambda: torch.ones(4), 1) > 0


# -- plans ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    plan = tplan.auto_plan(TINY, target_cr=2.0, weight_bits=3, mode="kernel")
    cache = str(tmp_path_factory.mktemp("tuned"))
    return plan, autotune.tune_plan(plan, t=1, grid="tiny", timer=CountingTimer(),
                                    cache_dir=cache, device="cpu")


def test_tune_plan_provenance(tuned):
    plan, tp = tuned
    rec = tp.provenance["tuned_blocks"]
    layers = tplan.inventory_for(TINY)()
    kernel_layers = {lp.name for lp in plan.layers if lp.spec is not None}
    assert set(rec) == kernel_layers
    for l in layers:
        if l.name in rec:
            r = rec[l.name]
            assert r["T"] == (l.rounds if l.kind == "conv" else 1)
            assert r["tuned_us"] <= r["heuristic_us"] and r["bit_identical"] is True
            assert {"bt", "bk", "bn", "fused_fold", "T", "source"} <= set(r)
            assert r["key"] == autotune.tune_key(plan.layers[layers.index(l)].spec, 3, r["T"])
    assert {r["source"] for r in rec.values()} <= {"timed", "cache"}


def test_tuned_plan_crosses_both_ways(tuned, tmp_path):
    """The port's file loads in the reference and saves back byte for byte,
    and the other way round; both read the same blocks into their layer
    configs."""
    _, tp = tuned
    p1, p2, p3 = (str(tmp_path / f"{n}.json") for n in "abc")
    tp.save(p1)
    jp = jplan.EpitomePlan.load(p1)
    jp.save(p2)
    tplan.EpitomePlan.load(p2).save(p3)
    raw = [open(p, "rb").read() for p in (p1, p2, p3)]
    assert raw[0] == raw[1] == raw[2]
    assert jp.tuned_blocks() == tp.tuned_blocks()
    tcfg, jcfg = dict(tp.layer_configs()), dict(jp.layer_configs())
    for name, (blocks, fused) in tp.tuned_blocks().items():
        assert tcfg[name].blocks == jcfg[name].blocks == blocks
        assert tcfg[name].fused_fold == jcfg[name].fused_fold == fused
    assert any(c.blocks is not None for c in tcfg.values())


def test_untouched_plan_has_no_tuned_blocks(tuned):
    plan, _ = tuned
    assert plan.tuned_blocks() == {}
    assert all(c.blocks is None for _, c in plan.layer_configs())


def test_tuned_plan_serves_bit_identical(tuned):
    """Every winner is bit-identical to its heuristic, so the tuned model's
    logits equal the untuned model's."""
    plan, tp = tuned
    assert all(r["bit_identical"] for r in tp.provenance["tuned_blocks"].values())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3),
                                                                 dtype=np.float32))
    base = get_resnet(TINY, plan=plan, device="cpu").init().prepack()
    model = get_resnet(TINY, plan=tp, device="cpu")
    assert any(c.blocks is not None for c in model.cfgs.values())
    model.load_params(base.params()).prepack()
    with torch.no_grad():
        assert torch.equal(model.apply(x), base.apply(x))


def test_tune_plan_on_an_lm_plan(tmp_path):
    """LM projections tune at T = t (the decode batch) and their winners
    reach the smoke config's layer configs."""
    plan = tplan.legalize_plan(tplan.search_plan("rwkv6-7b-smoke", weight_bits=3,
                                                 evo=EvoConfig(population=8, iterations=2, seed=0)))
    tp = autotune.tune_plan(plan, t=4, timer=CountingTimer(), cache_dir=str(tmp_path),
                            device="cpu")
    rec = tp.provenance["tuned_blocks"]
    assert rec and all(r["T"] == 4 for r in rec.values())
    cfgs = dict(tp.layer_configs())
    for name, (blocks, fused) in tp.tuned_blocks().items():
        assert cfgs[name].blocks == blocks and cfgs[name].fused_fold == fused
