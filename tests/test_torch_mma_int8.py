"""Kernel #1's tensor-core sum (csrc/epitome_mma.cuh): the factored int8
product with the activation as hi + lo passes, held to the plain version at
the reference's tolerances, every pack block, one bf16 pass missing the
gate, and the split-K picks of kernels #1-#3.

The models and cases are ``tests/mma_models.py``'s; nothing here needs a
card."""
import numpy as np
import pytest
import torch

from repro_torch.core.epitome import EpitomeSpec
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops, ref

from mma_models import BF16, CASES, FP32, _case, _hi_fp16_lo, _over, mma_model
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


@pytest.mark.parametrize("args,T", CASES)
def test_hi_lo_passes_hold_the_fp32_gate(args, T):
    spec, x, p, cb = _case(args, T)
    y = mma_model(_hi_fp16_lo(x), p.q, p.scales, p.zeros, cb, p.bk, p.bn)
    r = ref.quant_epitome_matmul_blocks_ref(x, p.q, p.scales, p.zeros, cb, p.bk, p.bn)
    torch.testing.assert_close(y, r, rtol=FP32, atol=FP32)


@pytest.mark.parametrize("args,T", CASES)
def test_bf16_activation_is_one_exact_pass(args, T):
    """A bf16 activation is exact in bf16: one pass, within the fp32 gate of
    the float32 product of the same values, and within the bf16 gate once
    both round to bf16."""
    spec, x, p, cb = _case(args, T)
    xb = x.bfloat16()
    y = mma_model([xb.float()], p.q, p.scales, p.zeros, cb, p.bk, p.bn)
    r32 = ref.quant_epitome_matmul_blocks_ref(xb.float(), p.q, p.scales, p.zeros, cb,
                                              p.bk, p.bn)
    torch.testing.assert_close(y, r32, rtol=FP32, atol=FP32)
    rb = ref.quant_epitome_matmul_blocks_ref(xb, p.q, p.scales, p.zeros, cb, p.bk, p.bn)
    torch.testing.assert_close(y.bfloat16().float(), rb.float(), rtol=BF16, atol=BF16)


def test_one_bf16_pass_misses_the_fp32_gate():
    """Why a float32 activation takes more than one pass: rounded once to
    bf16 it falls outside 2e-4 at the LM's and ResNet's shapes, where the
    hi + lo split holds."""
    missed = []
    for args, T in CASES:
        spec, x, p, cb = _case(args, T)
        r = ref.quant_epitome_matmul_blocks_ref(x, p.q, p.scales, p.zeros, cb, p.bk, p.bn)
        one = mma_model([x.bfloat16().float()], p.q, p.scales, p.zeros, cb, p.bk, p.bn)
        missed.append(_over(one, r, FP32))
    assert any(missed), "one bf16 pass held the fp32 gate everywhere"


@pytest.mark.parametrize("bits", [3, 8])
@pytest.mark.parametrize("bk", [8, 16, 32, 64, 128, 256])
def test_every_pack_block_and_a_ragged_m(bk, bits):
    """Every pack bk that pack_blocks makes, with a prime m (a ragged last
    pack block) and 8-bit codes, through the factored sum of the kernels'
    hi + lo split."""
    args = (512, 512, 251, 256, 128, 256)
    spec = EpitomeSpec(*args)
    rng = np.random.default_rng(bk + bits)
    E = torch.from_numpy((rng.standard_normal((spec.m, spec.n)) / np.sqrt(spec.M))
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((9, spec.m)).astype(np.float32))
    p = ops.pack_epitome(E, spec, QuantConfig(bits=bits), blocks=(8, bk, spec.bn))
    assert p.bk == bk
    cb = torch.as_tensor(ops.kernel_col_blocks(spec, p.bn))
    y = mma_model(_hi_fp16_lo(x), p.q, p.scales, p.zeros, cb, p.bk, p.bn)
    r = ref.quant_epitome_matmul_blocks_ref(x, p.q, p.scales, p.zeros, cb, p.bk, p.bn)
    torch.testing.assert_close(y, r, rtol=FP32, atol=FP32)


@pytest.mark.parametrize("args,T,rows", [
    ((1024, 16, 256), 4, 64),       # rwkv6-7b (1024, 4096): 128-row splits give 256 < 264 blocks
    ((1024, 56, 256), 4, 128),      # (1024, 14336): 8 splits x 112 tiles
    ((3584, 16, 256), 4, 128),      # (3584, 4096): 28 splits x 32 tiles
    ((2000, 4, 256), 32, 128),      # ResNet-50 fc at batch 32: T > 8 takes 128 rows
    ((1024, 16, 256), 33, 512),     # past the cut-over: tensor cores, 32 tiles, 2 splits
    ((1024, 16, 256), 1024, 0),     # prefill rows: 256 tiles fill the card
    ((2304, 2, 256), 1568, 576),    # ResNet-50 layer4 3x3: 52 tiles, 4 splits of 18 steps
    ((576, 1, 256), 6272, 0),       # 98 tiles but 18 steps: too short to split
])
def test_split_rows_picks(args, T, rows):
    """The wrapper's split-K picks (kernel #1): the decode loop takes two
    waves of 132 SMs where it can; the tensor-core loop splits only few
    tiles with a long contraction."""
    from repro_torch.kernels.quant_epitome_matmul import DECODE_ROWS, split_rows
    m, gn, bn = args
    got = split_rows(T, m, gn, bn)
    assert got == rows
    if T <= DECODE_ROWS:
        assert got in (64, 128)
        if got == 64:
            assert -(-m // 128) * gn * -(-bn // 128) < 2 * 132
    elif got:
        assert got % 32 == 0 and got // 32 >= 16
    assert split_rows(T, m, gn, bn, decode=False) % 32 == 0


@pytest.mark.parametrize("args,T,rows", [
    ((2000, 4, 256), 32, 128),      # ResNet-50 fc at batch 32: 8 tiles, 16 splits of 4 steps
    ((1024, 16, 256), 4, 256),      # rwkv6-7b (1024, 4096): 32 tiles, 4 splits
    ((3584, 16, 256), 4, 896),      # (3584, 4096): 32 tiles, 4 splits of 28 steps
    ((1024, 56, 256), 4, 0),        # (1024, 14336): 112 tiles, a wave already
    ((2000, 4, 256), 33, 672),      # past the cut-over: 3 splits of 21 steps (16 at least)
])
def test_split_rows_of_the_tensor_core_loop_at_decode_rows(args, T, rows):
    """Kernels #2 and #3 run the tensor-core loop at every T; at T <= 32
    their one row tile is mostly masked, so they split into one wave of
    blocks however short each split (measured on the card against 2-4
    splits of 16 steps: ResNet-50's fc 0.053 -> 0.019 ms)."""
    from repro_torch.kernels.quant_epitome_matmul import split_rows
    m, gn, bn = args
    got = split_rows(T, m, gn, bn, decode=False)
    assert got == rows
    if got:
        assert got % 32 == 0 and -(-m // got) * gn * -(-bn // 128) <= 132
