"""Kernel #3's float32 entry (csrc/epitome_fp_mma.cuh), 3xTF32, held to its
plain version at ResNet-50's CR-4 shapes, where one TF32 pass misses the
gate.

The models and cases are ``tests/mma_models.py``'s; nothing here needs a
card."""
import pytest
import torch

from repro_torch.kernels import ref

from mma_models import FP32, RESNET_CR4, _fp_case, _over, tf32_model
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


def test_resnet_cr4_shapes_are_the_paths():
    from repro_torch.configs import get_resnet
    r50 = get_resnet("resnet50", "kernel")
    shapes = []
    for spec in r50.specs:
        if spec is not None and (spec.M, spec.N, spec.m, spec.n, spec.bm, spec.bn) not in shapes:
            shapes.append((spec.M, spec.N, spec.m, spec.n, spec.bm, spec.bn))
    assert shapes == RESNET_CR4


@pytest.mark.parametrize("args", RESNET_CR4)
def test_three_tf32_passes_hold_the_fp32_gate(args):
    spec, E, folded, cb = _fp_case(args)
    y = tf32_model(folded, E, cb, spec.bn)
    torch.testing.assert_close(y, ref.epitome_matmul_blocks_ref(folded, E, cb, spec.bn),
                               rtol=FP32, atol=FP32)


def test_one_tf32_pass_misses_the_fp32_gate():
    """Why kernel #3's float32 entry takes three TF32 products: one TF32
    pass (10-bit operands) falls outside 2e-4 at every CR-4 shape."""
    for args in RESNET_CR4:
        spec, E, folded, cb = _fp_case(args, T=16)
        r = ref.epitome_matmul_blocks_ref(folded, E, cb, spec.bn)
        assert _over(tf32_model(folded, E, cb, spec.bn, passes=1), r, FP32), args
