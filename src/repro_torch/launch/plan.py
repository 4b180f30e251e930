"""EpitomePlan driver: search | legalize | show | run.

The plan -> legalize -> execute pipeline from the command line:

  # Algorithm-1 evolution search, saved as a JSON plan artifact
  PYTHONPATH=src python -m repro_torch.launch.plan search --arch resnet50 \\
      --objective latency --weight-bits 3 --act-bits 9 --out plan.json

  # snap the searched specs to the kernel-exact families + re-simulate
  PYTHONPATH=src python -m repro_torch.launch.plan legalize --plan plan.json \\
      --out plan_legal.json

  # inspect a plan (per-layer spec / bits / snap error + predicted cost)
  PYTHONPATH=src python -m repro_torch.launch.plan show --plan plan_legal.json

  # run the planned model through the kernels on the card (--device cpu
  # runs the kernels' plain versions) and print predicted (PIM simulator)
  # against measured latency
  PYTHONPATH=src python -m repro_torch.launch.plan run --plan plan_legal.json \\
      --batch 32 --hw 224 --iters 5

Plans are the reference's format (``repro.launch.plan`` writes the same
JSON), so a plan from either package runs in the other.  Searching or
legalizing with measured kernel latency (``--measured``, ``--tune``) comes
with the tuning slice, and sharding by placement (``--mesh``) with the
scale-out slice; both are refused here.
"""
from __future__ import annotations

import argparse
import statistics
import time

_LATER = {
    "measured": "--measured (search by measured kernel latency) comes with the "
                "tuning slice of the port (ROADMAP item 13)",
    "tune": "--tune (autotuned kernel blocks) comes with the tuning slice of the "
            "port (ROADMAP item 13)",
    "mesh": "--mesh (sharding by placement) comes with the scale-out slice of the "
            "port (ROADMAP item 16)",
}


def _refuse_later(args) -> None:
    for flag, why in _LATER.items():
        if getattr(args, flag, None):
            raise SystemExit(f"[plan] {why}; not available yet")


def _load(path: str):
    from ..pim.plan import EpitomePlan
    return EpitomePlan.load(path)


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
    from ..pim.plan import search_plan
    evo = EvoConfig(population=args.population, iterations=args.iterations,
                    seed=args.seed)
    plan = search_plan(args.arch, objective=args.objective,
                       weight_bits=args.weight_bits or None,
                       act_bits=args.act_bits or None, evo=evo)
    plan.save(args.out)
    pred = plan.predicted
    print(f"[plan] searched {args.arch} ({args.objective}, "
          f"pop={args.population} x {args.iterations} iters): "
          f"{plan.n_epitomized}/{len(plan.layers)} layers epitomized, "
          f"predicted {pred['latency_s']*1e3:.3f}ms / "
          f"{pred['energy_j']*1e3:.3f}mJ / {pred['xbars']} XBs")
    print(f"[plan] saved -> {args.out}  (NOT legalized; run "
          f"`legalize --plan {args.out}` before executing)")


def cmd_legalize(args) -> None:
    from ..pim.plan import legalize_plan
    plan = _load(args.plan)
    patch = tuple(int(v) for v in args.patch.split("x")) if args.patch else None
    legal = legalize_plan(plan, patch=patch)
    legal.save(args.out)
    pred = legal.predicted
    print(f"[plan] legalized {plan.arch}: snap error "
          f"max={legal.snap_err_max:.3f} "
          f"mean={legal.snap_err_mean:.3f}; re-simulated "
          f"{pred['latency_s']*1e3:.3f}ms / {pred['energy_j']*1e3:.3f}mJ / "
          f"{pred['xbars']} XBs")
    _print_cost(legal)
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
    cost_hdr = f" {'pred_ms':>8}" if by_layer else ""
    tuned_hdr = f" {'tuned':<12}" if tuned else ""
    print(f"{'layer':<18} {'bits':>4} {'mode':<11} {'snap':>6} "
          f"{'placement':<16}{cost_hdr}{tuned_hdr} spec")
    for lp in plan.layers:
        pl = lp.placement
        where = "-" if pl is None else \
            f"{pl.row_axis or '.'}x{pl.col_axis or '.'}/{pl.scales[:4]}"
        cols = ""
        if by_layer:
            a = (by_layer.get(lp.name) or {}).get("analytic_s")
            cols = f" {'-' if a is None else f'{a*1e3:8.3f}':>8}"
        if tuned:
            t = tuned.get(lp.name)
            ttxt = "-" if t is None else (f"{t['bt']}x{t['bk']}x{t['bn']}"
                                          f"{'/fold' if t.get('fused_fold') else ''}")
            cols += f" {ttxt:<12}"
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
    tokens must equal the one-shot generate's."""
    import torch
    from ..kernels import launch_counts, reset_launch_counts
    from ..pim.plan import LM_SMOKE_SUFFIX
    from .serve import build_model, generate
    if not plan.arch.endswith(LM_SMOKE_SUFFIX):
        raise SystemExit(
            f"plan {plan.arch!r} targets the full-scale LM; run the matching "
            f"'{plan.arch}{LM_SMOKE_SUFFIX}' plan here, or serve the full model "
            f"with repro_torch.launch.serve --plan")
    arch = plan.arch[:-len(LM_SMOKE_SUFFIX)]
    cfg, params = build_model(arch, "off", True, args.seed, device, plan=plan)
    B, P, gen = args.batch, 8, 8
    prompts = torch.randint(0, cfg.vocab, (B, P), device=device,
                            generator=torch.Generator(device=device).manual_seed(args.seed))
    print(f"[plan] {plan.arch}: {plan.n_epitomized}/{len(plan.layers)} "
          f"projections epitomized")
    reset_launch_counts()
    toks, _ = generate(params, cfg, prompts, P + gen + 1, gen)
    launches = {k: v for k, v in launch_counts().items() if v}
    if args.decode_block > 1:
        from .engine import EpimEngine, Request
        engine = EpimEngine(cfg, params, capacity=B, max_len=P + gen + 1,
                            decode_block=args.decode_block, device=device)
        for row in prompts.tolist():
            engine.submit(Request(prompt=row, max_new_tokens=gen))
        comps = engine.drain()
        same = all(tuple(toks[i].tolist()) == c.tokens for i, c in enumerate(comps))
        st = engine.stats
        print(f"[plan] engine decode_block={args.decode_block}: "
              f"steps={st['decode_steps']} micro_steps={st['decode_micro_steps']} "
              f"bit_identical={same}")
        if not same:
            raise AssertionError("the engine's greedy tokens drifted from the "
                                 "one-shot generate's")
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        toks, _ = generate(params, cfg, prompts, P + gen + 1, gen)
        toks = toks.cpu()                  # waits for the device
        times.append(time.perf_counter() - t0)
    pred = plan.predicted or {}
    print(f"[plan] predicted (PIM simulator): "
          f"{pred.get('latency_s', float('nan'))*1e3:.3f}ms "
          f"/ {pred.get('energy_j', float('nan'))*1e3:.3f}mJ "
          f"/ {pred.get('xbars', '-')} XBs")
    print(f"[plan] measured ({_where(device)}; batch={B} prompt={P} gen={gen}): "
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
    s.add_argument("--measured", action="store_true", help="not available yet")
    s.set_defaults(fn=cmd_search)

    s = sub.add_parser("legalize",
                       help="snap a plan to the kernel-exact families")
    s.add_argument("--plan", required=True)
    s.add_argument("--patch", default="",
                   help="execution patch 'BMxBN' (default: per-arch)")
    s.add_argument("--out", default="plan_legal.json")
    s.add_argument("--mesh", default="", help="not available yet")
    s.add_argument("--tune", action="store_true", help="not available yet")
    s.add_argument("--measured", action="store_true", help="not available yet")
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
    s.add_argument("--mesh", default="", help="not available yet")
    s.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    _refuse_later(args)
    args.fn(args)


if __name__ == "__main__":
    main()
