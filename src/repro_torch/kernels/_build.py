"""Build the CUDA kernels under ``csrc/`` with nvcc and bind them with ctypes.

Each ``.cu`` source becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) into ``build/kernels/`` at the repo root at
first use.  A library's file name carries a hash of every source in
``csrc/`` and of the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  All missing libraries are compiled at once, one
nvcc process per source.  nvcc's output (ptxas' registers and spills) is
kept beside each library as ``lib<name>-<hash>.log`` and read back when the
library is found built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_P, _I = ctypes.c_void_p, ctypes.c_int
# library -> (source, {C function: argtypes}); every pointer and the stream
# are c_void_p so ctypes never cuts them to 32 bits
LIBRARIES = {
    "epitome_matmul": ("epitome_matmul.cu", {
        "epitome_matmul_blocks_launch": [_P] * 6 + [_I] * 6 + [_P],
        "epitome_matmul_blocks_bf16_launch": [_P] * 6 + [_I] * 6 + [_P],
    }),
    "quant_epitome_matmul": ("quant_epitome_matmul.cu", {
        "quant_epitome_matmul_blocks_launch": [_P] * 8 + [_I] * 8 + [_P],
        "quant_epitome_matmul_fused_fold_launch": [_P] * 9 + [_I] * 10 + [_P],
    }),
    "quant_epitome_matmul_bf16": ("quant_epitome_matmul_bf16.cu", {
        "quant_epitome_matmul_blocks_bf16_launch": [_P] * 8 + [_I] * 8 + [_P],
    }),
    "quant_matmul": ("quant_matmul.cu", {
        "quant_matmul_launch": [_P] * 8 + [_I] * 4 + [_P],
        "quant_matmul_bf16_launch": [_P] * 8 + [_I] * 4 + [_P],
    }),
    "wkv6": ("wkv6.cu", {
        "wkv6_chunked_launch": [_P] * 8 + [_I] * 6 + [_P],
    }),
    "wkv6_bwd": ("wkv6_bwd.cu", {
        "wkv6_chunked_bwd_launch": [_P] * 16 + [_I] * 5 + [_P],
        "wkv6_chunked_bwd_scratch": [_I] * 3 + [_P],
    }),
    "mamba_scan": ("mamba_scan.cu", {
        "mamba_scan_launch": [_P] * 9 + [_I] * 5 + [_P],
    }),
    "mamba_scan_bwd": ("mamba_scan_bwd.cu", {
        "mamba_scan_bwd_launch": [_P] * 17 + [_I] * 5 + [_P],
        "mamba_scan_bwd_scratch": [_I] * 3 + [_P],
        "mamba_scan_bwd_occupancy": [_I] * 2 + [_P],
    }),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}    # library -> nvcc output of its build (kept on disk)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every library that is not built yet, all in parallel, and
    return {library: path}.  Raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name, (src, _) in LIBRARIES.items():
            out = _target(name)
            if out.exists():
                if name not in build_log and out.with_suffix(".log").exists():
                    build_log[name] = out.with_suffix(".log").read_text()
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            build_log[name] = log
            if proc.returncode:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            else:
                # the log first: a library found built always has its log
                tmp_log = tmp.with_suffix(".log")
                tmp_log.write_text(log)
                os.replace(tmp_log, out.with_suffix(".log"))
                os.replace(tmp, out)     # atomic: a concurrent loader sees all or nothing
        if failed:
            raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failed))
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: _target(name) for name in LIBRARIES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        if name not in _loaded:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in LIBRARIES[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a C entry returned a CUDA error (cudaGetLastError after the
    launch): a refused launch never runs, and a later synchronize would not
    report it."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError_t {rc}")


def require_cuda(kernel: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Validate the tensors a kernel reads before passing their pointers:
    all on ``ref``'s CUDA device and contiguous."""
    if ref.device.type != "cuda":
        raise ValueError(f"{kernel}: takes CPU tensors (plain version) or CUDA "
                         f"tensors (kernel), got device {ref.device}")
    for arg, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{kernel}: {arg} is on {t.device}, expected {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {arg} must be contiguous")


def require_dtype(kernel: str, arg: str, t: torch.Tensor, *dtypes: torch.dtype) -> None:
    """Raise unless ``t`` has one of ``dtypes`` (the kernel's only types)."""
    if t.dtype not in dtypes:
        names = " or ".join(str(d) for d in dtypes)
        raise TypeError(f"{kernel}: {arg} must be {names}, got {t.dtype}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


MAX_ROW_TILES = 65535     # gridDim.y limit, counted in 64-row tiles (the kernels' are 128)


def require_rows(kernel: str, T: int) -> None:
    if -(-T // 64) > MAX_ROW_TILES:
        raise ValueError(f"{kernel}: {T} rows exceed the {64 * MAX_ROW_TILES}-row grid")
