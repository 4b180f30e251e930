"""The epitome operator and epitome-aware quantization (counterpart of
``repro.core``).  The layers live in ``core.layers``, which builds on the
kernels and is imported on its own."""
from .epitome import (
    EpitomeSpec, epitome_matmul_ref, epitomize_dense, folded_matmul, init_epitome,
    overlap_counts, overlap_mask, plan_epitome, reconstruct, wrapped_matmul,
)
from .quant import (QuantConfig, dequantize_epitome, fake_quant, quant_mse,
                    quantize_epitome)
