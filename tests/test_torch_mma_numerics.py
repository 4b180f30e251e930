"""The arithmetic of the int8-epitome kernels' tensor-core main loop
(csrc/epitome_mma.cuh), modelled in plain torch on the CPU.

The kernels take (s, z) out of the product: per pack block b and output
block j, y += s * (x_b . q_b + z * sum_k x_k), with x_b . q_b on bf16 tensor
cores.  The model runs the same factored sum with the activation as one
bf16, as hi + lo (two bf16), as hi = bf16(x) and lo = fp16((x - hi) 2^8)
(what the float32 entries run) and, for a bf16 activation, exactly; it is
held against ``ref.quant_epitome_matmul_blocks_ref`` at the reference's
tolerances, and the float32 entries' split against the float64 sum.  Kernel #2's
fold (each epitome row summing its virtual rows from the inverse table, in
ascending order) is held to ``ref.fold_blocks_ref`` bit for bit.  Inputs
are drawn with numpy from a seed; nothing here needs a card."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.epitome import EpitomeSpec
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops, ref

FP32 = 2e-4     # |y - ref| <= tol + tol |ref|, tests/test_kernels.py:17-18
BF16 = 2e-2

# rwkv6-7b kernel-q3's three projections (M, N, m, n, bm, bn), pack bk 256
LM_SPECS = [(4096, 4096, 1024, 4096, 256, 256), (4096, 14336, 1024, 14336, 256, 256),
            (14336, 4096, 3584, 4096, 256, 256)]
# three ResNet-50 CR-4 shapes, pack bk 16 (fc), 32 and 256
RESNET_SPECS = [(2048, 1000, 2000, 256, 256, 256), (1152, 128, 288, 128, 256, 128),
                (576, 64, 256, 64, 256, 64)]
CASES = ([(a, T) for a in LM_SPECS for T in (4, 64)]
         + [(a, 64) for a in RESNET_SPECS])


def _case(args, T, seed=0):
    rng = np.random.default_rng(seed)
    spec = EpitomeSpec(*args)
    E = torch.from_numpy((rng.standard_normal((spec.m, spec.n)) / np.sqrt(spec.M))
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((T, spec.m)).astype(np.float32))
    p = ops.pack_epitome(E, spec, QuantConfig(bits=3))
    return spec, x, p, torch.as_tensor(ops.kernel_col_blocks(spec, p.bn))


def mma_model(passes, q, scales, zeros, cb, bk, bn, dtype=torch.float32):
    """The kernels' sum: for each pack block b in order, the float32 running
    sum gains s * (P + z * R), P the products of the passes (bf16 or fp16
    values times integer codes, summed in float32) and R their row sums.
    With ``dtype=torch.float64`` and x itself as the one pass: the exact sum."""
    T, m = passes[0].shape
    nb = -(-m // bk)
    cb = [int(c) for c in cb]
    qf = F.pad(q.to(dtype), (0, 0, 0, nb * bk - m)).reshape(nb, bk, -1, bn)[:, :, cb]
    parts = [F.pad(p.to(dtype), (0, nb * bk - m)).reshape(T, nb, bk) for p in passes]
    y = torch.zeros(T, len(cb), bn, dtype=dtype)
    for b in range(nb):
        P = sum(torch.einsum("tk,kjc->tjc", part[:, b], qf[b]) for part in parts)
        R = sum(part[:, b].sum(-1) for part in parts)
        s, z = scales[b, cb].to(dtype), zeros[b, cb].to(dtype)
        y = y + s[None, :, None] * (P + z[None, :, None] * R[:, None, None])
    return y.reshape(T, -1)


def _hi_lo(x):
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()]


def _hi_fp16_lo(x):
    """The float32 entries' split: hi = bf16(x), lo = fp16((x - hi) 2^8)
    (clamped at 65504), here with the 2^8 taken back out, as the kernel's
    lo pass does with codes scaled by 2^-8."""
    hi = x.bfloat16().float()
    return [hi, ((x - hi) * 256).clamp(-65504, 65504).half().float() / 256]


def _over(y, r, tol):
    return bool(((y - r).abs() > tol + tol * r.abs()).any())


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


@pytest.mark.parametrize("args,T", CASES)
def test_fp16_lo_split_near_float32_against_float64(args, T):
    """The float32 entries' split leaves under 2^-20 |x| of x out, so their
    sum is about as close to the float64 one as the plain float32 version
    (within 2.5x; 1.0-1.8x at these shapes), where hi + lo in two bf16
    (2^-17 |x|) is over 5x away at every shape: its error grows through
    ResNet-50's 53 layers to most of chip_smoke.py's card-vs-CPU logits
    gate."""
    spec, x, p, cb = _case(args, T)
    args_ = (p.q, p.scales, p.zeros, cb, p.bk, p.bn)
    y64 = mma_model([x], *args_, dtype=torch.float64)
    err = lambda y: float(((y.double() - y64).abs() / (1 + y64.abs())).max())
    plain = err(ref.quant_epitome_matmul_blocks_ref(x, *args_))
    assert err(mma_model(_hi_fp16_lo(x), *args_)) <= 2.5 * plain
    assert err(mma_model(_hi_lo(x), *args_)) > 5 * plain


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


def table_fold(x, spec):
    """Kernel #2's fold: each epitome row starts at +0 and adds, in the
    table's ascending order, the virtual rows that sample it; a padded entry
    (M) reads the zero column."""
    table = torch.as_tensor(ops.fold_table(spec))          # (m, c)
    xp = F.pad(x, (0, 1))
    folded = torch.zeros(x.shape[0], spec.m)
    for c in range(table.shape[1]):
        folded = folded + xp[:, table[:, c]]
    return folded


@pytest.mark.parametrize("args", RESNET_SPECS + [
    (2304, 256, 256, 256, 128, 256),    # 17 virtual rows into one epitome row
    (4200, 128, 64, 128, 4, 128),       # gm = 1050 row blocks
    (512, 512, 251, 256, 128, 256),     # prime m
])
def test_table_fold_equals_fold_blocks_ref_bit_for_bit(args):
    spec = EpitomeSpec(*args)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((7, spec.M))
                         .astype(np.float32))
    assert torch.equal(table_fold(x, spec),
                       ref.fold_blocks_ref(x, spec.row_offsets(), spec.bm, spec.m))


def test_fold_table_on_device_is_the_kernels_layout():
    """SpecTables.fold, what the wrapper hands kernel #2, is the (m, c)
    inverse table column by column: entry c*m + k is row k's c-th virtual
    row."""
    spec = EpitomeSpec(1152, 128, 288, 128, 256, 128)
    flat = ops.spec_tables(spec, spec.bn, torch.device("cpu")).fold
    table = ops.fold_table(spec)
    assert flat.dtype == torch.int64 and flat.numel() == table.size
    np.testing.assert_array_equal(flat.reshape(-1, spec.m).T.numpy(), table)


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
