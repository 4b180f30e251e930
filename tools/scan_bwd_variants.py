#!/usr/bin/env python3
"""Time text-edited variants of the scan gradient's kernel on the card.

    python3 tools/scan_bwd_variants.py [VARIANTS.json]

Each variant is a list of (old, new) text replacements applied to
``src/repro_torch/kernels/csrc/mamba_scan_bwd.cu`` (an empty list is the
kernel as it stands).  Every variant is compiled with the port's nvcc
flags into ``build/variants/`` (all at once), loaded with ctypes and timed
through ``mamba_scan_bwd_launch`` at jamba's training shape, 8 x 256 tokens
of di 16384 and 16 states, bf16 dt, x, B, C, a float32 dy, no h0 or dhT:
three readings of the device ms a launch (CUDA events over 50 launches
after 100).  A variant that skips work computes wrong values on purpose;
``equal`` says which of the seven outputs equal the first variant's bits.
Prints one JSON line with the card's name and power limit.  Needs a card
and nvcc; the default variants file is ``scan_bwd_variants.json`` beside
this script.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu"
OUT = ROOT / "build" / "variants"
B, S, DI, DS = 8, 256, 16384, 16


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_variants: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    path = Path(sys.argv[1]) if len(sys.argv) > 1 else Path(__file__).with_name(
        "scan_bwd_variants.json")
    variants = json.loads(path.read_text())
    OUT.mkdir(parents=True, exist_ok=True)
    base = SOURCE.read_text()
    procs = {}
    for name, edits in variants.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in {SOURCE.name}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
               str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    ptxas = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}:\n{log}")
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if ("Used" in line and "registers" in line) or "spill" in line]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f = lambda *s: torch.randn(s, device=dev, generator=gen)
    dt = torch.nn.functional.softplus(f(B, S, DI) - 1.0).bfloat16()
    x, Bm, Cm = f(B, S, DI).bfloat16(), f(B, S, DS).bfloat16(), f(B, S, DS).bfloat16()
    A, D, dy = -torch.exp(f(DI, DS) * 0.5), f(DI), f(B, S, DI)
    outs = [torch.empty(s, device=dev) for s in
            ((B, S, DI), (B, S, DI), (B, S, DS), (B, S, DS), (DI, DS), (DI,), (B, DI, DS))]
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    result, first = dict(card=card, B=B, S=S, di=DI, ds=DS, dtype="bfloat16"), None
    for name in variants:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fn = lib.mamba_scan_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        scratch_fn = lib.mamba_scan_bwd_scratch
        scratch_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        floats = ctypes.c_longlong()
        _build.check_launch(scratch_fn(B, S, DI, ctypes.byref(floats)), name)
        scratch = torch.empty((floats.value,), device=dev)

        def call():
            rc = fn(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
                    D.data_ptr(), None, dy.data_ptr(), None, *[o.data_ptr() for o in outs],
                    scratch.data_ptr(), B, S, DI, DS, 1, stream)
            _build.check_launch(rc, name)
        call()
        torch.cuda.synchronize()
        got = [o.clone() for o in outs]
        first = first or got
        for _ in range(100):
            call()
        ms = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                call()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / 50)
        result[name] = dict(ms=ms, ptxas=ptxas[name],
                            equal=[bool(torch.equal(a, b)) for a, b in zip(got, first)])
        del scratch
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
