"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a card: whether one is present is
decided in the ``cuda_device`` fixture, never at import, so every worker
collects the same tests.  Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Imports only torch, numpy and the port (that machine has no JAX)."""
import numpy as np
import pytest
import torch

from repro_torch.core.epitome import EpitomeSpec
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels.epitome_matmul import epitome_matmul_blocks
from repro_torch.kernels.quant_epitome_matmul import (
    quant_epitome_matmul_blocks, quant_epitome_matmul_fused_fold)

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-4, atol=2e-4)        # fp32, tests/test_kernels.py:17-18

# two of ResNet-50's kernel shapes at batch 32 x 224^2: a 3x3 conv with pack
# bk 32, and fc with m=2000 (pack bk 16) and 4 output blocks trimmed to 1000
SHAPES = [
    ((1152, 128, 288, 128, 256, 128), 25088),
    ((2048, 1000, 2000, 256, 256, 256), 32),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(args, T, device):
    g = torch.Generator().manual_seed(T)
    spec = EpitomeSpec(*args)
    E = (torch.randn(spec.m, spec.n, generator=g) / spec.M ** 0.5).to(device)
    x = torch.randn(T, spec.M, generator=g).to(device)
    packed = ops.pack_epitome(E, spec, QuantConfig(bits=3))
    cb = ops.spec_tables(spec, packed.bn, x.device).col_blocks
    return spec, E, x, packed, cb


@pytest.mark.parametrize("args,T", SHAPES)
def test_epitome_matmul_blocks_kernel(args, T, cuda_device):
    spec, E, x, _, cb = _case(args, T, cuda_device)
    folded = ops.fold_rows(x, spec)
    y = epitome_matmul_blocks(folded, E, cb, bn=spec.bn)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ref.epitome_matmul_blocks_ref(folded, E, cb, spec.bn), **TOL)


@pytest.mark.parametrize("args,T", SHAPES)
def test_quant_epitome_matmul_blocks_kernel(args, T, cuda_device):
    spec, _, x, p, cb = _case(args, T, cuda_device)
    folded = ops.fold_rows(x, spec)
    y = quant_epitome_matmul_blocks(folded, p.q, p.scales, p.zeros, cb, bk=p.bk, bn=p.bn)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        y, ref.quant_epitome_matmul_blocks_ref(folded, p.q, p.scales, p.zeros, cb,
                                               p.bk, p.bn), **TOL)


@pytest.mark.parametrize("args,T", SHAPES)
def test_quant_epitome_matmul_fused_fold_kernel(args, T, cuda_device):
    spec, _, x, p, cb = _case(args, T, cuda_device)
    ro = ops.spec_tables(spec, p.bn, x.device).row_offsets
    y = quant_epitome_matmul_fused_fold(x, p.q, p.scales, p.zeros, cb, ro,
                                        bm=spec.bm, bk=p.bk, bn=p.bn)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        y, ref.quant_epitome_matmul_fused_fold_ref(x, p.q, p.scales, p.zeros, cb, ro,
                                                   bm=spec.bm, bk=p.bk, bn=p.bn), **TOL)


def test_ragged_rows_and_prime_m(cuda_device):
    """T not a multiple of the 64-row tile and a prime m, through ops."""
    spec, E, x, _, _ = _case((512, 512, 251, 256, 128, 256), 97, cuda_device)
    cpu = ops.quant_epitome_matmul(x.cpu(), E.cpu(), spec, QuantConfig(bits=8))
    for fused in (False, True):
        y = ops.quant_epitome_matmul(x, E, spec, QuantConfig(bits=8), fused_fold=fused)
        torch.testing.assert_close(y.cpu(), cpu, **TOL)
    torch.testing.assert_close(ops.epitome_matmul(x, E, spec).cpu(),
                               ops.epitome_matmul(x.cpu(), E.cpu(), spec), **TOL)


def test_cuda_tensors_launch_or_raise(cuda_device):
    spec, E, x, p, cb = _case(*SHAPES[1], cuda_device)
    reset_launch_counts()
    ops.quant_epitome_matmul(x, None, spec, packed=p)
    assert launch_counts()["quant_epitome_matmul_blocks"] == 1
    folded = ops.fold_rows(x, spec)
    with pytest.raises(TypeError, match="bfloat16"):
        epitome_matmul_blocks(folded.bfloat16(), E.bfloat16(), cb, bn=spec.bn)
    with pytest.raises(ValueError, match="E is on cpu"):
        epitome_matmul_blocks(folded, E.cpu(), cb, bn=spec.bn)
    with pytest.raises(ValueError, match="contiguous"):
        quant_epitome_matmul_blocks(folded.t().contiguous().t(), p.q, p.scales, p.zeros,
                                    cb, bk=p.bk, bn=p.bn)


def test_tiny_resnet_on_card_matches_cpu(cuda_device):
    from repro_torch.configs import get_resnet
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3),
                                                                  dtype=np.float32))
    for variant in ("kernel-q3", "kernel"):
        gpu = get_resnet("tiny-resnet", variant).init().prepack()
        cpu = get_resnet("tiny-resnet", variant, device="cpu").load_params(
            {k: _to(v, "cpu") for k, v in gpu.params().items()})
        reset_launch_counts()
        with torch.no_grad():
            y, r = gpu.apply(x.to(cuda_device)).cpu(), cpu.apply(x)
        assert sum(launch_counts().values()) == len(gpu.layers)
        torch.testing.assert_close(y, r, rtol=0, atol=1e-4 * max(1.0, float(r.abs().max())))


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.detach().to(device)
            for k, v in tree.items()}
