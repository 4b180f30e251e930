#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the repo root, on a machine with a card

The main path is EPIM-ResNet-50 at 3-bit epitome-aware quantization,
``get_resnet("resnet50", "kernel-q3")`` -> ``prepack`` -> ``apply``: 45
epitomized layers, each one launch of the fused int8 kernel.  Phases:

1. build   — nvcc builds the kernels from ``src/repro_torch/kernels/csrc``;
             prints ptxas' registers and shared memory, and the card's name
             and power limit as nvidia-smi gives them.
2. kernels — each of the three kernels at each of ResNet-50's 16 distinct
             kernel shapes (batch 32, 224x224) against its plain PyTorch
             version on the card, then timed (CUDA events) beside its plain
             version and the torch.matmul yardstick, with its bound.
3. forward — ResNet-50 kernel-q3, kernel and kernel-q3 with every layer's
             fold inside the kernel (fused_fold), from seeded weights at
             batch 32: each launch counter must rise by exactly 45 per
             forward; then the same model at batch 2 on the card against
             the plain versions on the CPU.
   The batch-32 forward is timed and its peak memory recorded.
4. times   — each kernel's times and bound summed over one forward's 45
             launches.

Any failure exits nonzero.  The line before the last is a JSON object
listing the kernels; the last line is ``{"ok": true, "device": ...}``.
Details go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH, IMAGE, SEED = 32, 224, 0
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12       # H100 SXM HBM3
KERNEL_TOL = 2e-4           # |y - ref| <= tol + tol*|ref|, fp32 (tests/test_kernels.py:17-18)
# Logits of the card against the CPU, relative to max(1, max|logit|): the
# tolerance of the CPU parity tests against the JAX reference.  fp32 sums
# run in another order through 53 conv/matmul layers, each followed by
# batch-statistics BatchNorm that rescales the differences by 1/std.
LOGIT_TOL = 1e-4
KERNELS = {   # kernel -> (source, the TPU kernel it replaces)
    "quant_epitome_matmul_blocks": (
        "src/repro_torch/kernels/csrc/quant_epitome_matmul.cu",
        "src/repro/kernels/quant_epitome_matmul.py:66"),
    "quant_epitome_matmul_fused_fold": (
        "src/repro_torch/kernels/csrc/quant_epitome_matmul.cu",
        "src/repro/kernels/quant_epitome_matmul.py:143"),
    "epitome_matmul_blocks": (
        "src/repro_torch/kernels/csrc/epitome_matmul.cu",
        "src/repro/kernels/epitome_matmul.py:50"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, budget_ms: float = 40.0) -> float:
    """Mean device time of fn() over a run of launches, by CUDA events,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, min(200, math.ceil(budget_ms / max(1e-3, 1e3 * (time.perf_counter() - t0)))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown(torch, fn) -> list:
    """Device time of one call of fn by kernel, [(name, ms, calls)] sorted
    by time, from torch.profiler; [] where the profiler sees no device
    time (then the breakdown is not measured)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:       # no device tracing here: a gap, not a fault
        log(f"[profile] not measured: {e}")
        return []
    timed = [e for e in prof.key_averages() if (e.self_device_time_total or 0) > 0]
    # kernels where the profiler lists them on their own, else the ops that
    # launched them
    kernels = [e for e in timed if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in kernels or timed]
    return sorted(rows, key=lambda r: -r[1])


def max_err(torch, y, ref, tol: float, what: str) -> float:
    err = (y - ref).abs()
    bad = err > tol + tol * ref.abs()
    if not torch.isfinite(y).all() or bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements over tolerance, "
                             f"max |y - ref| = {float(err.max()):.3e}")
    return float(err.max())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_resnet
        from repro_torch.kernels import (KERNELS as WRAPPERS, _build, launch_counts,
                                         ops, ref, reset_launch_counts)
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"[env] {kind} | {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| python {sys.version.split()[0]}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(built)} libraries in {report['build_s']:.1f} s (sm_90a)")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- the main path's kernel shapes ------------------------------------
    r50 = get_resnet("resnet50", "kernel-q3")
    shapes = {}
    for l, spec in zip(r50.layers, r50.specs):
        if spec is None:
            continue
        T = BATCH * (l.out_hw ** 2 if l.kind == "conv" else 1)
        shapes.setdefault((spec, T), []).append(l.name)
    n_layers = sum(len(v) for v in shapes.values())
    log(f"[shapes] {n_layers} epitomized layers in {len(shapes)} kernel shapes")
    if n_layers != 45 or len(shapes) != 16:
        raise AssertionError("ResNet-50 kernel-q3 should have 45 epitomized layers "
                             "in 16 shapes")

    # -- 2. kernels against their plain versions, and their times ---------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for (spec, T), names in shapes.items():
        for r in check_and_time(torch, dev, gen, ops, ref, WRAPPERS, spec, T):
            r.update(layers=names, count=len(names))
            rows.append(r)
            log(f"[kernels] {r['kernel']} ({spec.M},{spec.N})->({spec.m},{spec.n}) T={T} "
                f"bk={r['pack_bk']} x{len(names)}: max_err={r['max_abs_err']:.2e} "
                f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']})")
        torch.cuda.empty_cache()

    # -- 3. the main path, full width --------------------------------------
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, device=dev, generator=gen)
    small = images[:2].contiguous()
    epitomized = [l.name for l, s in zip(r50.layers, r50.specs) if s is not None]
    paths = [("kernel-q3", None, "quant_epitome_matmul_blocks"),
             ("kernel", None, "epitome_matmul_blocks"),
             ("kernel-q3", {n: (None, True) for n in epitomized},
              "quant_epitome_matmul_fused_fold")]
    launches, forwards = {}, []
    for variant, tuned, kernel in paths:
        label = variant + ("+fused_fold" if tuned else "")
        model = get_resnet("resnet50", variant, tuned=tuned).init(
            torch.Generator().manual_seed(SEED)).prepack()
        with torch.no_grad():
            reset_launch_counts()
            logits = model.apply(images)
            torch.cuda.synchronize()
            counts = launch_counts()
            expect = {k: (45 if k == kernel else 0) for k in counts}
            if counts != expect:
                raise AssertionError(f"{label}: launches {counts}, expected {expect}")
            if logits.shape != (BATCH, 1000) or not torch.isfinite(logits).all():
                raise AssertionError(f"{label}: logits {tuple(logits.shape)} not finite")
            launches[kernel] = counts[kernel]
            times, host = [], []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(5):
                t0 = time.perf_counter()
                model.apply(images)
                host.append(1e3 * (time.perf_counter() - t0))   # until apply returns
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            peak = torch.cuda.max_memory_allocated()
            breakdown = device_breakdown(torch, lambda: model.apply(images))
            y2 = model.apply(small).cpu()
            cpu = get_resnet("resnet50", variant, tuned=tuned, device="cpu").load_params(
                _to_cpu(model.params()))
            r2 = cpu.apply(small.cpu())
        scale = max(1.0, float(r2.abs().max()))
        err = float((y2 - r2).abs().max())
        if not err <= LOGIT_TOL * scale:
            raise AssertionError(f"{label}: batch-2 logits on the card differ from the "
                                 f"CPU by {err:.3e} (> {LOGIT_TOL} * {scale:.3f})")
        fwd = dict(path=label, kernel=kernel, launches=counts[kernel],
                   forward_ms_median=statistics.median(times), forward_ms=times,
                   host_ms=host, device_breakdown=breakdown,
                   peak_bytes=peak, logits_max_abs=float(logits.abs().max()),
                   b2_card_vs_cpu_max_abs_err=err, b2_ref_max_abs=scale)
        forwards.append(fwd)
        log(f"[forward] {label}: {kernel} launches={counts[kernel]} "
            f"b{BATCH} forward median {fwd['forward_ms_median']:.2f} ms "
            f"(runs {', '.join(f'{t:.2f}' for t in times)}; host returns after "
            f"{statistics.median(host):.2f}) peak {peak / 2**30:.2f} GiB; "
            f"b2 card vs cpu max|dy|={err:.3e} (max|y|={scale:.3f})")
        for name, ms, n in breakdown[:8]:
            log(f"[profile] {label}: {ms:9.3f} ms  x{n:<4d} {name[:90]}")
        del model, cpu

    # -- 4. times per kernel, summed over one forward's launches -----------
    summary = []
    for name in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        per_fwd = lambda key: sum(r[key] * r["count"] for r in mine)
        by = {b: sum(r["bound_ms"] * r["count"] for r in mine if r["bound_by"] == b)
              for b in ("bytes", "operations")}
        summary.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
            "bound_ms": per_fwd("bound_ms"), "bound_by": max(by, key=by.get),
            "library_ms": per_fwd("library_ms")})
        log(f"[times] {name}: per batch-{BATCH} forward ({launches[name]} launches) "
            f"{summary[-1]['ms']:.3f} ms, bound {summary[-1]['bound_ms']:.3f} ms")

    report.update(kernels=summary, shapes=rows, forwards=forwards, card_end=card_line())
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(report["card_end"])
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def check_and_time(torch, dev, gen, ops, ref, wrappers, spec, T):
    """The three kernels at one main-path shape: each against its plain
    version on the same inputs, then timed beside its plain version and the
    yardstick, with the least time the card could take."""
    from repro_torch.core.quant import QuantConfig, dequantize_packed
    E = torch.randn(spec.m, spec.n, device=dev, generator=gen) / math.sqrt(spec.M)
    x = torch.randn(T, spec.M, device=dev, generator=gen)
    p = ops.pack_epitome(E, spec, QuantConfig(bits=3))
    bn = spec.bn
    tables = ops.spec_tables(spec, bn, x.device)
    cb, ro = tables.col_blocks, tables.row_offsets
    # operands padded as ops.quant_epitome_matmul / ops.epitome_matmul pad them
    q = torch.nn.functional.pad(p.q, (0, 0, 0, (-spec.m) % p.bk))
    folded = torch.nn.functional.pad(ops.fold_rows(x, spec), (0, q.shape[0] - spec.m))
    ffold, fE = ops._pad_contraction(ops.fold_rows(x, spec), E, ops._pick_bk(spec.m))
    # the yardstick: one torch.matmul of the folded activation with the
    # pre-expanded (dequantized) weight; the port never calls it
    cols = torch.cat([torch.arange(c * bn, (c + 1) * bn, device=dev)
                      for c in ops.kernel_col_blocks(spec, bn).tolist()])
    W_q = dequantize_packed(q, p.scales, p.zeros, (p.bk, bn))[:, cols].contiguous()
    W_f = fE[:, cols].contiguous()
    gn = len(cb)
    calls = {
        "quant_epitome_matmul_blocks": (
            lambda: wrappers["quant_epitome_matmul_blocks"](
                folded, q, p.scales, p.zeros, cb, bk=p.bk, bn=bn),
            lambda: ref.quant_epitome_matmul_blocks_ref(
                folded, q, p.scales, p.zeros, cb, p.bk, bn),
            lambda: torch.matmul(folded, W_q)),
        "quant_epitome_matmul_fused_fold": (
            lambda: wrappers["quant_epitome_matmul_fused_fold"](
                x, q, p.scales, p.zeros, cb, ro, bm=spec.bm, bk=p.bk, bn=bn),
            lambda: ref.quant_epitome_matmul_fused_fold_ref(
                x, q, p.scales, p.zeros, cb, ro, bm=spec.bm, bk=p.bk, bn=bn),
            lambda: torch.matmul(folded, W_q)),
        "epitome_matmul_blocks": (
            lambda: wrappers["epitome_matmul_blocks"](ffold, fE, cb, bn=bn),
            lambda: ref.epitome_matmul_blocks_ref(ffold, fE, cb, bn),
            lambda: torch.matmul(ffold, W_f)),
    }
    # the bound: each input read once and the output written once, against
    # the FMAs of the contraction (the fused fold adds one add per input)
    flops = 2.0 * T * q.shape[0] * gn * bn
    out_b = 4.0 * T * gn * bn
    code_b = q.numel() + 8.0 * p.scales.numel() + 4.0 * gn
    work = {"quant_epitome_matmul_blocks": (4.0 * folded.numel() + code_b + out_b, flops),
            "quant_epitome_matmul_fused_fold": (4.0 * x.numel() + code_b + 4.0 * len(ro) + out_b,
                                                flops + T * spec.M),
            "epitome_matmul_blocks": (4.0 * (ffold.numel() + fE.numel() + gn) + out_b, flops)}
    rows = []
    for name, (kernel, plain, library) in calls.items():
        err = max_err(torch, kernel(), plain(), KERNEL_TOL, f"{name} {spec} T={T}")
        t_bytes = work[name][0] / HBM_BYTES_S * 1e3
        t_ops = work[name][1] / FP32_FLOPS * 1e3
        rows.append(dict(kernel=name, M=spec.M, N=spec.N, m=spec.m, n=spec.n, bm=spec.bm,
                         bn=bn, T=T, pack_bk=p.bk, max_abs_err=err,
                         ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain),
                         library_ms=time_ms(torch, library),
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes > t_ops else "operations"))
    return rows


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.detach().cpu()
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
