"""Kernel #3's 3xTF32 sum against float64 at ResNet-50's CR-4 shapes.

The models and cases are ``tests/mma_models.py``'s; nothing here needs a
card."""
import pytest

from repro_torch.kernels import ref

from mma_models import RESNET_CR4, _fp_case, tf32_model
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


@pytest.mark.parametrize("args", RESNET_CR4)
def test_three_tf32_near_float32_against_float64(args):
    """What 3xTF32 drops (x_lo E_lo, and lo's own rounding: about 2^-21 of
    each product) keeps it within 2.5x of the plain float32 product's
    distance from float64 (0.5-1.8x at these shapes)."""
    spec, E, folded, cb = _fp_case(args)
    r64 = ref.epitome_matmul_blocks_ref(folded.double(), E.double(), cb, spec.bn)
    err = lambda y: float(((y.double() - r64).abs() / (1 + r64.abs())).max())
    plain = err(ref.epitome_matmul_blocks_ref(folded, E, cb, spec.bn))
    assert err(tf32_model(folded, E, cb, spec.bn)) <= 2.5 * plain
