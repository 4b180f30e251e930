"""The epitome operator and epitome-aware quantization (counterpart of
``repro.core``).  The layers live in ``core.layers``, which builds on the
kernels and is imported on its own."""
from .epitome import (
    EpitomeSpec, epitome_matmul_ref, folded_matmul, init_epitome,
    overlap_counts, overlap_mask, plan_epitome, reconstruct, wrapped_matmul,
)
from .quant import QuantConfig, fake_quant, quantize_epitome
