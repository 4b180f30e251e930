"""EpitomePlan driver: search | legalize | show | run.

The plan -> legalize -> execute pipeline from the command line:

  # Algorithm-1 evolution search, saved as a JSON plan artifact
  PYTHONPATH=src python -m repro_torch.launch.plan search --arch resnet50 \\
      --objective latency --weight-bits 3 --act-bits 9 --out plan.json

  # hardware-in-the-loop: re-rank each generation's elite front by kernel
  # latency measured on the card (memoized in benchmarks/tuned/) and emit a
  # legalized plan with analytic + measured cost in provenance
  PYTHONPATH=src python -m repro_torch.launch.plan search --arch resnet50 \\
      --objective latency --weight-bits 3 --act-bits 9 --measured --out plan.json

  # snap the searched specs to the kernel-exact families + re-simulate
  PYTHONPATH=src python -m repro_torch.launch.plan legalize --plan plan.json \\
      --out plan_legal.json

  # ... and time the kernels' pack blocks and fold variant per layer on the
  # card, recording the winners in provenance['tuned_blocks']
  PYTHONPATH=src python -m repro_torch.launch.plan legalize --plan plan.json \\
      --tune --tune-t 32 --out plan_tuned.json

  # inspect a plan (per-layer spec / bits / snap error + predicted cost)
  PYTHONPATH=src python -m repro_torch.launch.plan show --plan plan_legal.json

  # run the planned model through the kernels on the card (--device cpu
  # runs the kernels' plain versions) and print predicted (PIM simulator)
  # against measured latency
  PYTHONPATH=src python -m repro_torch.launch.plan run --plan plan_legal.json \\
      --batch 32 --hw 224 --iters 5

Plans are the reference's format (``repro.launch.plan`` writes the same
JSON), so a plan from either package runs in the other.  ``--measured``
and ``--tune`` time on ``--device`` (the card by default; ``--device cpu``
times the kernels' plain versions on the host) and share the port's cache
file, ``benchmarks/tuned/torch-<device type>.json`` (``--measure-cache``,
``--tune-cache``).

Sharded serving by placement: ``legalize --mesh DATA,MODEL`` also snaps
every layer's placement to that mesh; ``run --mesh DATA,MODEL`` serves an
LM plan on the mesh (``launch.mesh``; under ``torchrun`` for more than one
rank) with its codes laid out by placement, and checks the prefill logits
and greedy tokens against the same plan served whole on one rank, bit for
bit (the two ``bit-identical=`` lines; rank 0 prints):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \
      -m repro_torch.launch.plan run --plan plan_legal.json --mesh 2,4 --device cpu
"""
from __future__ import annotations

import argparse
import statistics
import time

def _load(path: str):
    from ..pim.plan import EpitomePlan
    return EpitomePlan.load(path)


def _cost_model(args, arch: str):
    """The CostModel the --measured flags select (None = analytic default).
    One factory shared by search and legalize so both score with the same
    keys and the same cache file."""
    if not getattr(args, "measured", False):
        return None
    from ..pim.costmodel import measured_cost_for
    return measured_cost_for(arch, t=args.measure_t,
                             iters=args.measure_iters,
                             cache_dir=args.measure_cache or None,
                             device=args.device)


def _add_measure_flags(s) -> None:
    s.add_argument("--measured", action="store_true",
                   help="hardware-in-the-loop: score by measured kernel "
                        "latency (memoized per legalized spec/bits/T in the "
                        "autotuner cache); degrades to analytic with a "
                        "warning if timing is unavailable")
    s.add_argument("--measure-t", type=int, default=1,
                   help="per-image batch assumed when deriving measured T")
    s.add_argument("--measure-iters", type=int, default=2,
                   help="timing iterations per measured kernel")
    s.add_argument("--measure-cache", default="",
                   help="measurement-cache dir (default: benchmarks/tuned/, "
                        "shared with legalize --tune)")
    s.add_argument("--device", default="cuda",
                   help="where --measured and --tune time the kernels "
                        "(cpu: their plain versions, a host time)")


def _print_cost(plan) -> None:
    c = plan.provenance.get("cost")
    if not c:
        return
    meas = c.get("measured_s")
    meas_txt = "n/a (analytic only)" if meas is None else f"{meas*1e3:.3f}ms"
    print(f"[plan] cost ({c.get('model')}, T base {c.get('t')}): "
          f"analytic={c['analytic_s']*1e3:.3f}ms measured={meas_txt}")


def _fmt_spec(spec) -> str:
    if spec is None:
        return "dense"
    return (f"{spec.m}x{spec.n} (of {spec.M}x{spec.N}, "
            f"patch {spec.bm}x{spec.bn}, CR {spec.compression_rate:.2f})")


def cmd_search(args) -> None:
    from ..pim.evo import EvoConfig
    from ..pim.plan import legalize_plan, search_plan
    evo = EvoConfig(population=args.population, iterations=args.iterations,
                    seed=args.seed)
    cost = _cost_model(args, args.arch)
    plan = search_plan(args.arch, objective=args.objective,
                       weight_bits=args.weight_bits or None,
                       act_bits=args.act_bits or None, evo=evo,
                       cost=cost, measure_top_k=args.measure_top_k)
    if cost is not None:
        # hardware-in-the-loop output contract: the saved artifact is the
        # legalized design the measurements were keyed on, with both cost
        # columns stamped — ready for `run`, no separate legalize step
        plan = legalize_plan(plan, cost=cost)
    plan.save(args.out)
    pred = plan.predicted
    print(f"[plan] searched {args.arch} ({args.objective}, "
          f"pop={args.population} x {args.iterations} iters): "
          f"{plan.n_epitomized}/{len(plan.layers)} layers epitomized, "
          f"predicted {pred['latency_s']*1e3:.3f}ms / "
          f"{pred['energy_j']*1e3:.3f}mJ / {pred['xbars']} XBs")
    if cost is not None:
        gens = plan.provenance.get("measured_elites") or []
        n_meas = sum(1 for g in gens if g.get("measured"))
        print(f"[plan] measured elites: {n_meas}/{len(gens)} generations "
              f"ranked by measured latency on {args.device} ({cost.timings} "
              f"timings for {cost.lookups} layer lookups; degraded="
              f"{not cost.available})")
        _print_cost(plan)
        print(f"[plan] saved -> {args.out}  (legalized; ready for "
              f"`run --plan {args.out}`)")
    else:
        print(f"[plan] saved -> {args.out}  (NOT legalized; run "
              f"`legalize --plan {args.out}` before executing)")


def cmd_legalize(args) -> None:
    from ..pim.plan import legalize_plan
    plan = _load(args.plan)
    patch = tuple(int(v) for v in args.patch.split("x")) if args.patch else None
    mesh_shape = None
    if args.mesh:
        from .mesh import parse_mesh
        data, model = parse_mesh(args.mesh)
        mesh_shape = {"data": data, "model": model}
    legal = legalize_plan(plan, patch=patch, mesh_shape=mesh_shape,
                          cost=_cost_model(args, plan.arch))
    if args.tune:
        from ..kernels.autotune import tune_plan
        legal = tune_plan(legal, t=args.tune_t, grid=args.tune_grid,
                          iters=args.tune_iters,
                          cache_dir=args.tune_cache or None, device=args.device)
        rec = legal.provenance.get("tuned_blocks") or {}
        for name, r in sorted(rec.items()):
            print(f"[tune] {name}: bt={r['bt']} bk={r['bk']} bn={r['bn']} "
                  f"fused_fold={r['fused_fold']} "
                  f"tuned={r['tuned_us']:.1f}us heuristic="
                  f"{r['heuristic_us']:.1f}us source={r['source']}")
    legal.save(args.out)
    pred = legal.predicted
    print(f"[plan] legalized {plan.arch}: snap error "
          f"max={legal.snap_err_max:.3f} "
          f"mean={legal.snap_err_mean:.3f}; re-simulated "
          f"{pred['latency_s']*1e3:.3f}ms / {pred['energy_j']*1e3:.3f}mJ / "
          f"{pred['xbars']} XBs")
    _print_cost(legal)
    for name, reasons in (legal.provenance.get("placement_fallbacks") or {}).items():
        print(f"[plan] placement fallback {name}: {'; '.join(reasons)}")
    print(f"[plan] saved -> {args.out}")


def cmd_show(args) -> None:
    plan = _load(args.plan)
    prov = plan.provenance
    print(f"plan: arch={plan.arch} planner={prov.get('planner')} "
          f"objective={prov.get('objective', '-')} "
          f"legalized={plan.is_legalized()}")
    if plan.predicted:
        p = plan.predicted
        print(f"predicted: latency={p['latency_s']*1e3:.3f}ms "
              f"energy={p['energy_j']*1e3:.3f}mJ xbars={p['xbars']} "
              f"util={p['utilization']*100:.1f}%")
    cost = prov.get("cost") or {}
    by_layer = {l.get("name"): l for l in cost.get("layers", [])
                if isinstance(l, dict)}
    tuned = prov.get("tuned_blocks") or {}
    if cost:
        _print_cost(plan)
    cost_hdr = f" {'pred_ms':>8} {'meas_ms':>8} {'src':<6}" if by_layer else ""
    tuned_hdr = f" {'tuned':<15}" if tuned else ""
    print(f"{'layer':<18} {'bits':>4} {'mode':<11} {'snap':>6} "
          f"{'placement':<16}{cost_hdr}{tuned_hdr} spec")
    for lp in plan.layers:
        pl = lp.placement
        where = "-" if pl is None else \
            f"{pl.row_axis or '.'}x{pl.col_axis or '.'}/{pl.scales[:4]}"
        cols = ""
        if by_layer:
            c = by_layer.get(lp.name) or {}
            a, m = c.get("analytic_s"), c.get("measured_s")
            cols = (f" {'-' if a is None else f'{a*1e3:8.3f}':>8}"
                    f" {'-' if m is None else f'{m*1e3:8.3f}':>8}"
                    f" {c.get('source', '-'):<6}")
        if tuned:
            t = tuned.get(lp.name)
            ttxt = "-" if t is None else (f"{t['bt']}x{t['bk']}x{t['bn']}/"
                                          f"{t.get('source', '?')[:4]}"
                                          f"{'/fold' if t.get('fused_fold') else ''}")
            cols += f" {ttxt:<15}"
        print(f"{lp.name:<18} {lp.weight_bits or '-':>4} {lp.mode:<11} "
              f"{lp.snap_err:>6.3f} {where:<16}{cols} {_fmt_spec(lp.spec)}")


def _where(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return f"{device.type}, the kernels' plain versions; a host time, not a device time"


def _run_lm(plan, args, device) -> None:
    """Serve a legalized '<arch>-smoke' LM plan: plan-driven smoke config,
    prepacked, greedy generate of a few tokens; with ``--decode-block K``
    > 1 also through the engine at K micro-steps a dispatch, whose greedy
    tokens must equal the one-shot generate's.

    With ``--mesh DATA,MODEL`` the codes are laid out on the mesh by the
    plan's placements and served sharded; the sharded prefill logits and
    greedy tokens must equal the same plan's on one rank bit for bit, and
    its kernels launch as often.  Every rank runs both; rank 0 prints."""
    import torch
    from ..core.layers import Sharded
    from ..kernels import launch_counts, reset_launch_counts
    from ..models import lm
    from ..models.common import set_mesh
    from ..train.tree import leaves
    from ..pim.plan import LM_SMOKE_SUFFIX
    from .mesh import describe, destroy_world, mesh_for_plan, parse_mesh, say
    from .serve import build_model, generate
    if not plan.arch.endswith(LM_SMOKE_SUFFIX):
        raise SystemExit(
            f"plan {plan.arch!r} targets the full-scale LM; run the matching "
            f"'{plan.arch}{LM_SMOKE_SUFFIX}' plan here, or serve the full model "
            f"with repro_torch.launch.serve --plan")
    arch = plan.arch[:-len(LM_SMOKE_SUFFIX)]
    cfg, params = build_model(arch, "off", True, args.seed, device, plan=plan)
    B, P, gen = args.batch, 8, 8
    max_len = P + gen + 1
    prompts = torch.randint(0, cfg.vocab, (B, P), device=device,
                            generator=torch.Generator(device=device).manual_seed(args.seed))
    say(f"[plan] {plan.arch}: {plan.n_epitomized}/{len(plan.layers)} "
        f"projections epitomized")
    reset_launch_counts()
    toks, _ = generate(params, cfg, prompts, max_len, gen)
    launches = {k: v for k, v in launch_counts().items() if v}
    if args.decode_block > 1:
        from .engine import EpimEngine, Request
        engine = EpimEngine(cfg, params, capacity=B, max_len=max_len,
                            decode_block=args.decode_block, device=device)
        for row in prompts.tolist():
            engine.submit(Request(prompt=row, max_new_tokens=gen))
        comps = engine.drain()
        same = all(tuple(toks[i].tolist()) == c.tokens for i, c in enumerate(comps))
        st = engine.stats
        say(f"[plan] engine decode_block={args.decode_block}: "
            f"steps={st['decode_steps']} micro_steps={st['decode_micro_steps']} "
            f"bit_identical={same}")
        if not same:
            raise AssertionError("the engine's greedy tokens drifted from the "
                                 "one-shot generate's")
    if args.mesh:
        with torch.no_grad():
            ref_logits, _ = lm.prefill(params, prompts,
                                       lm.init_decode_state(cfg, B, max_len, device), cfg)
        mesh = mesh_for_plan(plan, *parse_mesh(args.mesh), device=device)
        set_mesh(mesh)
        try:
            params = lm.prepack_params(params, cfg, mesh=mesh)
            split = [l for l in leaves(params) if isinstance(l, Sharded) and l.is_split()]
            say(f"[plan] mesh: {describe(mesh)}; {len(split)} parameter leaves split "
                f"across the ranks")
            with torch.no_grad():
                sh_logits, _ = lm.prefill(params, prompts, lm.init_decode_state(
                    cfg, B, max_len, device, mesh=mesh), cfg)
            reset_launch_counts()
            sh_toks, _ = generate(params, cfg, prompts, max_len, gen)
            sh_launches = {k: v for k, v in launch_counts().items() if v}
            logits_ok = torch.equal(ref_logits, sh_logits)
            toks_ok = torch.equal(toks, sh_toks)
            say(f"[plan] sharded vs single-device: logits bit-identical={logits_ok} "
                f"tokens bit-identical={toks_ok}; kernel launches per generate "
                f"{sh_launches} (one rank: {launches})")
            if not (logits_ok and toks_ok and sh_launches == launches):
                raise AssertionError("sharded serving drifted from the single-device "
                                     "prepacked path")
            _time_lm(plan, args, device, params, cfg, prompts, gen, sh_launches)
        finally:
            destroy_world()
        return
    _time_lm(plan, args, device, params, cfg, prompts, gen, launches)


def _time_lm(plan, args, device, params, cfg, prompts, gen, launches) -> None:
    from .mesh import say
    from .serve import generate
    B, P = prompts.shape
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        toks, _ = generate(params, cfg, prompts, P + gen + 1, gen)
        toks = toks.cpu()                  # waits for the device
        times.append(time.perf_counter() - t0)
    pred = plan.predicted or {}
    say(f"[plan] predicted (PIM simulator): "
        f"{pred.get('latency_s', float('nan'))*1e3:.3f}ms "
        f"/ {pred.get('energy_j', float('nan'))*1e3:.3f}mJ "
        f"/ {pred.get('xbars', '-')} XBs")
    say(f"[plan] measured ({_where(device)}; batch={B} prompt={P} gen={gen}): "
        f"{B * gen / statistics.median(times):.1f} tok/s; kernel launches per "
        f"generate {launches}")


def cmd_run(args) -> None:
    import torch
    plan = _load(args.plan)
    if not plan.is_legalized():
        raise SystemExit(f"plan {args.plan} is not legalized; searched specs "
                         "are not kernel-exact — run `legalize` first")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from ..pim.plan import is_lm_arch
    if is_lm_arch(plan.arch):
        _run_lm(plan, args, device)
        return
    if args.mesh:
        raise SystemExit("--mesh applies to LM plans (sharded weight-stationary "
                         "serving); ResNet plans run on one device")
    from ..kernels import launch_counts, reset_launch_counts
    from ..models.resnet import ResNetModel
    model = ResNetModel.from_plan(plan, device=device)
    # the contract of the pipeline: what runs IS what was planned
    if model.specs != plan.specs():
        raise AssertionError("specs in the running model drifted from the plan")
    print(f"[plan] {plan.arch}: mode={model.mode} "
          f"{plan.n_epitomized}/{len(plan.layers)} layers epitomized, "
          f"specs identical to the plan: True")
    tuned = plan.tuned_blocks()
    if tuned:
        print(f"[plan] tuned blocks honored for {len(tuned)} layer(s): "
              + ", ".join(f"{k}={v[0]}{'/fold' if v[1] else ''}"
                          for k, v in sorted(tuned.items())))
    model.init(torch.Generator().manual_seed(args.seed)).prepack()
    x = torch.randn(args.batch, args.hw, args.hw, 3,
                    generator=torch.Generator().manual_seed(args.seed + 1)).to(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        reset_launch_counts()
        y = model.apply(x)                         # warm-up (and kernel build)
        sync()
        launches = {k: v for k, v in launch_counts().items() if v}
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            y = model.apply(x)
            sync()
            times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("non-finite logits")
    pred = plan.predicted or {}
    print(f"[plan] predicted (PIM simulator): "
          f"{pred.get('latency_s', float('nan'))*1e3:.3f}ms "
          f"/ {pred.get('energy_j', float('nan'))*1e3:.3f}mJ "
          f"/ {pred.get('xbars', '-')} XBs")
    _print_cost(plan)
    print(f"[plan] measured ({_where(device)}; batch={args.batch} hw={args.hw}): "
          f"{statistics.median(times)*1e3:.3f}ms per forward, median of "
          f"{args.iters}; kernel launches per forward {launches}")
    print(f"[plan] logits {tuple(y.shape)} finite: True")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.plan", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("search", help="evolution-search a design -> plan JSON")
    s.add_argument("--arch", default="tiny-resnet")
    s.add_argument("--objective", default="latency",
                   choices=("latency", "energy", "edp"))
    s.add_argument("--weight-bits", type=int, default=0,
                   help="0 = fp weights; e.g. 3 for the flagship W3 rows")
    s.add_argument("--act-bits", type=int, default=0,
                   help="0 = fp activations (simulator-side only)")
    s.add_argument("--population", type=int, default=16)
    s.add_argument("--iterations", type=int, default=8)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--out", default="plan.json")
    _add_measure_flags(s)
    s.add_argument("--measure-top-k", type=int, default=4,
                   help="elite-front size re-ranked by measured latency "
                        "each generation (--measured only)")
    s.set_defaults(fn=cmd_search)

    s = sub.add_parser("legalize",
                       help="snap a plan to the kernel-exact families")
    s.add_argument("--plan", required=True)
    s.add_argument("--patch", default="",
                   help="execution patch 'BMxBN' (default: per-arch)")
    s.add_argument("--out", default="plan_legal.json")
    s.add_argument("--mesh", default="",
                   help="'DATA,MODEL': also snap every layer's placement to this mesh "
                        "(fallbacks reported in provenance)")
    s.add_argument("--tune", action="store_true",
                   help="autotune kernel pack blocks and the fused fold per "
                        "epitomized layer and record the winners in plan "
                        "provenance (schema-additive; plans without it run "
                        "unchanged)")
    s.add_argument("--tune-t", type=int, default=1,
                   help="per-image batch assumed when deriving the tuned T")
    s.add_argument("--tune-grid", default="tiny", choices=("tiny", "default"),
                   help="candidate-grid size for --tune")
    s.add_argument("--tune-iters", type=int, default=2)
    s.add_argument("--tune-cache", default="",
                   help="tuning-cache dir (default: benchmarks/tuned/)")
    _add_measure_flags(s)
    s.set_defaults(fn=cmd_legalize)

    s = sub.add_parser("show", help="print a plan")
    s.add_argument("--plan", required=True)
    s.set_defaults(fn=cmd_show)

    s = sub.add_parser("run", help="execute a legalized plan through the kernels")
    s.add_argument("--plan", required=True)
    s.add_argument("--batch", type=int, default=2)
    s.add_argument("--hw", type=int, default=16, help="input spatial size")
    s.add_argument("--iters", type=int, default=2)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--device", default="cuda")
    s.add_argument("--decode-block", type=int, default=1,
                   help="LM plans: also serve through the engine at this many "
                        "decode micro-steps a dispatch and require its greedy "
                        "tokens to equal the one-shot path's (1 = skip)")
    s.add_argument("--mesh", default="",
                   help="LM plans: 'DATA,MODEL' mesh to serve on with the codes laid out "
                        "by placement (under torchrun for more than one rank), checked "
                        "bit for bit against one rank")
    s.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
