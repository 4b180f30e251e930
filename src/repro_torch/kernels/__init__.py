"""The kernels, hand-written in CUDA C++ for Hopper (sm_90a).

epitome_matmul        — y = x_folded @ E, column blocks steered by the OFAT
                        table, float32 (3xTF32) or bfloat16 on the tensor
                        cores (``csrc/epitome_matmul.cu`` on
                        ``csrc/epitome_fp_mma.cuh``)
quant_epitome_matmul  — the same over int8 codes with one (scale, zero)
                        per pack block, float32 or bfloat16 activations,
                        and a variant that folds the activation inside the
                        kernel: bf16 tensor-core products on the codes,
                        split-K at decode rows
                        (``csrc/quant_epitome_matmul{,_bf16}.cu`` on
                        ``csrc/epitome_mma.cuh``)
wkv6                  — the chunked RWKV6 WKV with a carried state, its
                        chunk products on the TF32 tensor cores, r, k, v
                        in bfloat16 or float32 (``csrc/wkv6.cu``), and its
                        gradient, the token recurrence backward from
                        states stored every 8 tokens (``csrc/wkv6_bwd.cu``)
mamba_scan            — Mamba's selective scan with a carried state, one
                        thread per (batch, channel) with its states in
                        registers, dt, x, B, C in bfloat16 or float32
                        (``csrc/mamba_scan.cu``)
quant_matmul          — a dense int8 dequant matmul with one (scale, zero)
                        per 256 x 256 crossbar tile, float32 or bfloat16
                        activations (``csrc/quant_matmul.cu`` on
                        ``csrc/epitome_mma.cuh``)
ref                   — the plain PyTorch version of each kernel
ops                   — the public wrappers: fold, block picks, trim

Each kernel wrapper counts its launches in a plain integer attribute
``launches``; ``launch_counts`` reads them and ``reset_launch_counts`` sets
them to 0.  The sources are compiled with nvcc at first use
(``_build.py``), never at import.
"""
from .epitome_matmul import epitome_matmul_blocks
from .mamba_scan import mamba_scan
from .quant_epitome_matmul import (quant_epitome_matmul_blocks,
                                   quant_epitome_matmul_fused_fold)
from .quant_matmul import quant_matmul
from .wkv6 import wkv6_chunked, wkv6_chunked_bwd

KERNELS = {
    "quant_epitome_matmul_blocks": quant_epitome_matmul_blocks,
    "quant_epitome_matmul_fused_fold": quant_epitome_matmul_fused_fold,
    "epitome_matmul_blocks": epitome_matmul_blocks,
    "wkv6_chunked": wkv6_chunked,
    "quant_matmul": quant_matmul,
    "wkv6_chunked_bwd": wkv6_chunked_bwd,
    "mamba_scan": mamba_scan,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
