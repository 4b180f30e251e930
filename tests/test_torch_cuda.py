"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a card: whether one is present is
decided in the ``cuda_device`` fixture, never at import, so every worker
collects the same tests.  Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Imports only torch, numpy and the port (that machine has no JAX)."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core.epitome import EpitomeSpec
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels.epitome_matmul import epitome_matmul_blocks
from repro_torch.kernels.quant_epitome_matmul import (
    quant_epitome_matmul_blocks, quant_epitome_matmul_fused_fold)
from repro_torch.kernels.wkv6 import wkv6_chunked

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-4, atol=2e-4)        # fp32, tests/test_kernels.py:17-18
BF16 = dict(rtol=2e-2, atol=2e-2)       # bf16, tests/test_kernels.py:17-18
WKV = dict(rtol=1e-3, atol=1e-3)        # wkv6, tests/test_kernels.py:85

# two of ResNet-50's kernel shapes at batch 32 x 224^2: a 3x3 conv with pack
# bk 32, and fc with m=2000 (pack bk 16) and 4 output blocks trimmed to 1000
SHAPES = [
    ((1152, 128, 288, 128, 256, 128), 25088),
    ((2048, 1000, 2000, 256, 256, 256), 32),
]


# rwkv6-7b kernel-q3's three projection shapes (M, N, m, n, bm, bn)
LM_SHAPES = [(4096, 4096, 1024, 4096, 256, 256), (4096, 14336, 1024, 14336, 256, 256),
             (14336, 4096, 3584, 4096, 256, 256)]


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
    tables = ops.spec_tables(spec, p.bn, x.device)
    ro = tables.row_offsets
    y = quant_epitome_matmul_fused_fold(x, p.q, p.scales, p.zeros, cb, ro,
                                        bm=spec.bm, bk=p.bk, bn=p.bn, fold=tables.fold)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        y, ref.quant_epitome_matmul_fused_fold_ref(x, p.q, p.scales, p.zeros, cb, ro,
                                                   bm=spec.bm, bk=p.bk, bn=p.bn), **TOL)


@pytest.mark.parametrize("T,m,n,bn,cb", [
    (97, 251, 64, 32, [1, 0, 1]),       # ragged T, odd m, bn < 64, a repeated block
    (33, 77, 96, 48, [1, 0]),           # 48-wide blocks in a 64-column tile
    (4, 1000, 120, 30, [3, 0, 2, 2]),   # bn not a multiple of 4: plain copies
    (1, 300, 256, 128, [1, 0]),         # one row
    (130, 2048, 512, 256, [1, 1]),      # split-K over few tiles
])
def test_epitome_matmul_blocks_fp32_ragged(T, m, n, bn, cb, cuda_device):
    """Kernel #3's float32 entry (3xTF32) at ragged T, odd m and column
    blocks narrower than its 64-column tile, against its plain version."""
    g = torch.Generator().manual_seed(T + m)
    x = torch.randn(T, m, generator=g).to(cuda_device)
    E = (torch.randn(m, n, generator=g) / m ** 0.5).to(cuda_device)
    cbt = torch.tensor(cb, dtype=torch.int32, device=cuda_device)
    reset_launch_counts()
    y = epitome_matmul_blocks(x, E, cbt, bn=bn)
    torch.cuda.synchronize()
    assert launch_counts()["epitome_matmul_blocks"] == 1
    assert y.shape == (T, len(cb) * bn) and y.dtype == torch.float32
    torch.testing.assert_close(y, ref.epitome_matmul_blocks_ref(x, E, cbt, bn), **TOL)


@pytest.mark.parametrize("T", [4, 1024])
@pytest.mark.parametrize("args", LM_SHAPES)
def test_epitome_matmul_blocks_bf16_at_lm_shapes(args, T, cuda_device):
    """Kernel #3's bf16 entry at rwkv6-7b's projection shapes, as
    ops.epitome_matmul hands it a bf16 activation (E cast to bf16): bf16
    out, within the bf16 tolerance of its plain version."""
    spec, E, x, _, _ = _case(args, T, cuda_device)
    cb = ops.spec_tables(spec, spec.bn, cuda_device).col_blocks
    folded = ops.fold_rows(x.bfloat16(), spec)
    Eb = E.bfloat16()
    y = epitome_matmul_blocks(folded, Eb, cb, bn=spec.bn)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    plain = ref.epitome_matmul_blocks_ref(folded, Eb, cb, spec.bn)
    torch.testing.assert_close(y.float(), plain.float(), **BF16)
    out = ops.epitome_matmul(x.bfloat16(), E, spec)
    assert out.dtype == torch.bfloat16 and out.shape == (T, spec.N)


def test_epitome_matmul_blocks_refuses_mixed_and_other_dtypes(cuda_device):
    x = torch.randn(8, 64, device=cuda_device)
    E = torch.randn(64, 128, device=cuda_device)
    cb = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    for xd, ed in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        with pytest.raises(TypeError, match="dtype"):
            epitome_matmul_blocks(x.to(xd), E.to(ed), cb, bn=128)
    with pytest.raises(TypeError, match="float16"):
        epitome_matmul_blocks(x.half(), E.half(), cb, bn=128)


def test_ragged_rows_and_prime_m(cuda_device):
    """T not a multiple of the 64-row tile and a prime m, through ops."""
    spec, E, x, _, _ = _case((512, 512, 251, 256, 128, 256), 97, cuda_device)
    cpu = ops.quant_epitome_matmul(x.cpu(), E.cpu(), spec, QuantConfig(bits=8))
    for fused in (False, True):
        y = ops.quant_epitome_matmul(x, E, spec, QuantConfig(bits=8), fused_fold=fused)
        torch.testing.assert_close(y.cpu(), cpu, **TOL)
    torch.testing.assert_close(ops.epitome_matmul(x, E, spec).cpu(),
                               ops.epitome_matmul(x.cpu(), E.cpu(), spec), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 4, 7, 16, 17, 32, 33, 64, 1024])
def test_quant_blocks_kernel_around_the_decode_cut_over(T, dtype, cuda_device):
    """Kernel #1 at one LM width on both sides of the cut-over between the
    split-K decode loop (T <= 32) and the tensor-core loop: one launch per
    call, against its plain version."""
    from repro_torch.kernels.quant_epitome_matmul import DECODE_ROWS
    assert DECODE_ROWS == 32
    spec, _, x, p, cb = _case(LM_SHAPES[0], T, cuda_device)
    folded = ops.fold_rows(x.to(dtype), spec)
    reset_launch_counts()
    y = quant_epitome_matmul_blocks(folded, p.q, p.scales, p.zeros, cb, bk=p.bk, bn=p.bn)
    torch.cuda.synchronize()
    assert launch_counts()["quant_epitome_matmul_blocks"] == 1 and y.dtype == dtype
    plain = ref.quant_epitome_matmul_blocks_ref(folded, p.q, p.scales, p.zeros, cb, p.bk, p.bn)
    torch.testing.assert_close(y.float(), plain.float(),
                               **(TOL if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("T", [4, 100])
@pytest.mark.parametrize("bk", [8, 16, 32, 64, 128, 256])
def test_every_pack_bk_with_ragged_m_and_8bit_codes(bk, T, cuda_device):
    """Every pack bk that pack_blocks makes, at a prime m (the last pack
    block ragged) with 8-bit codes, through kernels #1 (fp32 and bf16) and
    #2, at decode and prefill rows."""
    spec = EpitomeSpec(512, 512, 251, 256, 128, 256)
    g = torch.Generator().manual_seed(bk + T)
    E = (torch.randn(spec.m, spec.n, generator=g) / spec.M ** 0.5).to(cuda_device)
    x = torch.randn(T, spec.M, generator=g).to(cuda_device)
    p = ops.pack_epitome(E, spec, QuantConfig(bits=8), blocks=(8, bk, spec.bn))
    assert p.bk == bk and p.q.shape[0] == 251
    tables = ops.spec_tables(spec, p.bn, cuda_device)
    cb = tables.col_blocks
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16)):
        folded = ops.fold_rows(x.to(dtype), spec)
        y = quant_epitome_matmul_blocks(folded, p.q, p.scales, p.zeros, cb, bk=bk, bn=p.bn)
        plain = ref.quant_epitome_matmul_blocks_ref(folded, p.q, p.scales, p.zeros, cb,
                                                    bk, p.bn)
        torch.testing.assert_close(y.float(), plain.float(), **tol)
    y = quant_epitome_matmul_fused_fold(x, p.q, p.scales, p.zeros, cb, tables.row_offsets,
                                        bm=spec.bm, bk=bk, bn=p.bn, fold=tables.fold)
    torch.testing.assert_close(
        y, ref.quant_epitome_matmul_fused_fold_ref(x, p.q, p.scales, p.zeros, cb,
                                                   tables.row_offsets, bm=spec.bm,
                                                   bk=bk, bn=p.bn), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_rows_repeat_bit_for_bit(dtype, cuda_device):
    """The split-K decode loop reduces its splits in a fixed order inside the
    launch (no atomics on the output): three launches, the same bits."""
    spec, _, x, p, cb = _case(LM_SHAPES[2], 4, cuda_device)
    folded = ops.fold_rows(x.to(dtype), spec)
    ys = [quant_epitome_matmul_blocks(folded, p.q, p.scales, p.zeros, cb, bk=p.bk, bn=p.bn)
          for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(y, ys[0]) for y in ys)


def test_split_launches_on_two_streams_at_once(cuda_device):
    """Split-K launches on two streams at the same time (each stream has its
    own ticket counters): every output equals the same launch made alone,
    bit for bit, for kernel #1's decode loop and kernel #2's split
    tensor-core loop."""
    from repro_torch.kernels.quant_epitome_matmul import split_rows
    spec, _, x, p, cb = _case(LM_SHAPES[2], 8, cuda_device)
    tables = ops.spec_tables(spec, p.bn, cuda_device)
    xr = torch.randn(64, spec.M, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    gn = cb.shape[0]
    assert split_rows(64, spec.m, gn, p.bn, decode=False) > 0
    calls = [lambda: quant_epitome_matmul_blocks(ops.fold_rows(x, spec), p.q, p.scales,
                                                 p.zeros, cb, bk=p.bk, bn=p.bn),
             lambda: quant_epitome_matmul_fused_fold(xr, p.q, p.scales, p.zeros, cb,
                                                     tables.row_offsets, bm=spec.bm,
                                                     bk=p.bk, bn=p.bn, fold=tables.fold)]
    alone = [f() for f in calls]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(calls[i]())
                outs[i].append(calls[1 - i]())
    torch.cuda.synchronize()
    for i in range(2):
        for k, y in enumerate(outs[i]):
            assert torch.equal(y, alone[(i + k) % 2]), (i, k)


def test_fused_fold_beyond_1024_row_blocks(cuda_device):
    """gm = 1050 virtual row blocks (a row-offset table the first kernel #2
    held in shared memory refused past 1024): the inverse fold table has no
    such cap."""
    spec = EpitomeSpec(4200, 128, 64, 128, 4, 128)
    assert spec.gm > 1024
    g = torch.Generator().manual_seed(5)
    E = (torch.randn(spec.m, spec.n, generator=g) / spec.M ** 0.5).to(cuda_device)
    x = torch.randn(100, spec.M, generator=g).to(cuda_device)
    p = ops.pack_epitome(E, spec, QuantConfig(bits=3))
    cpu = ops.quant_epitome_matmul(x.cpu(), E.cpu(), spec, QuantConfig(bits=3),
                                   fused_fold=True)
    reset_launch_counts()
    y = ops.quant_epitome_matmul(x, None, spec, packed=p, fused_fold=True)
    assert launch_counts()["quant_epitome_matmul_fused_fold"] == 1
    torch.testing.assert_close(y.cpu(), cpu, **TOL)


def test_cuda_tensors_launch_or_raise(cuda_device):
    spec, E, x, p, cb = _case(*SHAPES[1], cuda_device)
    reset_launch_counts()
    ops.quant_epitome_matmul(x, None, spec, packed=p)
    assert launch_counts()["quant_epitome_matmul_blocks"] == 1
    folded = ops.fold_rows(x, spec)
    with pytest.raises(TypeError, match="dtype"):
        epitome_matmul_blocks(folded.bfloat16(), E, cb, bn=spec.bn)
    with pytest.raises(ValueError, match="E is on cpu"):
        epitome_matmul_blocks(folded, E.cpu(), cb, bn=spec.bn)
    with pytest.raises(ValueError, match="contiguous"):
        quant_epitome_matmul_blocks(folded.t().contiguous().t(), p.q, p.scales, p.zeros,
                                    cb, bk=p.bk, bn=p.bn)
    ro = ops.spec_tables(spec, p.bn, x.device).row_offsets
    with pytest.raises(ValueError, match="inverse table"):
        quant_epitome_matmul_fused_fold(x, p.q, p.scales, p.zeros, cb, ro,
                                        bm=spec.bm, bk=p.bk, bn=p.bn)


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


def test_bf16_activation_through_quant_epitome_matmul(cuda_device):
    """A bfloat16 activation runs on the card and comes back bfloat16,
    within the reference's bf16 tolerance of the same call on the CPU."""
    spec, E, x, p, _ = _case(LM_SHAPES[0], 8, cuda_device)
    xb = x.bfloat16()
    y = ops.quant_epitome_matmul(xb, None, spec, packed=p)
    cpu = ops.quant_epitome_matmul(xb.cpu(), None, spec,
                                   packed=ops.PackedEpitome(*(t.cpu() for t in p[:3]), p.bk, p.bn))
    assert y.dtype == cpu.dtype == torch.bfloat16
    torch.testing.assert_close(y.cpu().float(), cpu.float(), **BF16)


@pytest.mark.parametrize("T", [4, 1024])
@pytest.mark.parametrize("args", LM_SHAPES)
def test_bf16_quant_epitome_matmul_blocks_kernel_at_lm_shapes(args, T, cuda_device):
    spec, _, x, p, cb = _case(args, T, cuda_device)
    folded = ops.fold_rows(x.bfloat16(), spec)
    y = quant_epitome_matmul_blocks(folded, p.q, p.scales, p.zeros, cb, bk=p.bk, bn=p.bn)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    plain = ref.quant_epitome_matmul_blocks_ref(folded, p.q, p.scales, p.zeros, cb, p.bk, p.bn)
    torch.testing.assert_close(y.float(), plain.float(), **BF16)


# qwen2-72b kernel-q3's four specs: a 256-wide epitome under 116 column
# blocks with the last one half used (N = 29568), a ragged contraction
# (m = 7392, pack bk 32) and an unfolded m = M = 8192; then gemma2-2b's
# (2304, 9216) -> (576, 9216), pack bk 64
QWEN2_SHAPES = [(8192, 8192, 2048, 8192, 256, 256), (8192, 1024, 8192, 256, 256, 256),
                (8192, 29568, 8192, 256, 256, 256), (29568, 8192, 7392, 8192, 256, 256),
                (2304, 9216, 576, 9216, 256, 256)]


@pytest.mark.parametrize("T", [1, 4, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("args", QWEN2_SHAPES)
def test_quant_epitome_matmul_at_attention_lm_shapes(args, dtype, T, cuda_device):
    """Kernel #1 through ops.quant_epitome_matmul (fold, launch, trim to N)
    at the attention LMs' ragged specs, one decode row (T = 1) included:
    one launch, against the plain version on the same card inputs, and the
    decode rows three times bit for bit."""
    spec, _, x, p, _ = _case(args, T, cuda_device)
    xd = x.to(dtype)
    reset_launch_counts()
    y = ops.quant_epitome_matmul(xd, None, spec, packed=p)
    torch.cuda.synchronize()
    assert launch_counts()["quant_epitome_matmul_blocks"] == 1
    assert y.dtype == dtype and tuple(y.shape) == (T, spec.N)
    cb = ops.spec_tables(spec, p.bn, cuda_device).col_blocks
    folded = ops.fold_rows(xd, spec)
    plain = ref.quant_epitome_matmul_blocks_ref(folded, p.q, p.scales, p.zeros, cb, p.bk,
                                                p.bn)[:, :spec.N]
    torch.testing.assert_close(y.float(), plain.float(),
                               **(TOL if dtype == torch.float32 else BF16))
    if T <= 4:
        again = [ops.quant_epitome_matmul(xd, None, spec, packed=p) for _ in range(3)]
        assert all(torch.equal(a, y) for a in again)


@pytest.mark.parametrize("arch", ["qwen2-72b", "gemma2-2b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("bits", [16, 8])
def test_smoke_attention_lm_on_card_matches_cpu(arch, bits, cuda_device):
    """An attention architecture's smoke config at kernel-q3 in float32
    (gemma2's prompt of 12 runs past its window of 8): every epitomized
    projection launched as kernel #1, greedy tokens equal to the plain
    versions' on the CPU, at a float and an int8 KV cache."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config(arch, "kernel-q3"), compute_dtype="float32",
                              kv_cache_bits=bits)
    gpu = lm.prepack_params(lm.init_params(torch.Generator().manual_seed(0), cfg, cuda_device), cfg)
    cpu = lm.prepack_params(lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
    sites = sum(lc.is_epitome for lc in lm.lm_layer_configs(cfg).values())
    reset_launch_counts()
    toks, _ = serve.generate(gpu, cfg, prompts.to(cuda_device), 20, 4)
    assert launch_counts()["quant_epitome_matmul_blocks"] == sites * cfg.n_groups * 4
    ref_toks, _ = serve.generate(cpu, cfg, prompts, 20, 4)
    assert torch.equal(toks.cpu(), ref_toks)


# K = 12 (not a multiple of 8) takes the kernel's element-wise staging;
# chunks shorter than a 16-token sub-chunk (S = 7 < chunk, chunk 8)
@pytest.mark.parametrize("B,S,H,K,chunk", [(2, 80, 4, 16, 64), (4, 200, 8, 64, 64),
                                           (2, 50, 2, 8, 16), (2, 50, 3, 12, 16),
                                           (1, 7, 2, 16, 64), (1, 21, 2, 16, 8)])
def test_wkv6_kernel_with_state_at_ragged_length(B, S, H, K, chunk, cuda_device):
    g = torch.Generator().manual_seed(S)
    f = lambda *s: torch.randn(s, generator=g).to(cuda_device)
    r, k, v = f(B, S, H, K), f(B, S, H, K), f(B, S, H, K)
    lw, u, h0 = -torch.exp(f(B, S, H, K) * 0.5), f(H, K) * 0.1, f(B, H, K, K) * 0.5
    reset_launch_counts()
    o, hT = wkv6_chunked(r, k, v, lw, u, h0, chunk=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["wkv6_chunked"] == 1
    o_ref, h_ref = ref.wkv6_chunked_ref(r, k, v, lw, u, h0, chunk=chunk)
    torch.testing.assert_close(o, o_ref, **WKV)
    torch.testing.assert_close(hT, h_ref, **WKV)
    o0, _ = wkv6_chunked(r, k, v, lw, u, chunk=chunk)        # zero state
    torch.testing.assert_close(o0, ref.wkv6_chunked_ref(r, k, v, lw, u, chunk=chunk)[0], **WKV)
    strong, h = wkv6_chunked(r, k, v, torch.full_like(lw, -20.0), u, h0, chunk=chunk)
    assert torch.isfinite(strong).all() and torch.isfinite(h).all()


def _wkv_inputs(B, S, H, K, device, dtype):
    g = torch.Generator().manual_seed(S + K)
    f = lambda *s: torch.randn(s, generator=g).to(device)
    r, k, v = (f(B, S, H, K).to(dtype) for _ in range(3))
    return r, k, v, -torch.exp(f(B, S, H, K) * 0.5), f(H, K) * 0.1, f(B, H, K, K) * 0.5


@pytest.mark.parametrize("B,S,H,K,chunk", [(4, 256, 64, 64, 64), (2, 80, 4, 16, 64),
                                           (2, 50, 2, 8, 16), (2, 50, 3, 12, 16)])
def test_wkv6_kernel_reads_bf16_rkv(B, S, H, K, chunk, cuda_device):
    """bf16 r, k, v (the LM's projections) straight into the kernel, against
    the plain version on the same values cast to float32."""
    r, k, v, lw, u, h0 = _wkv_inputs(B, S, H, K, cuda_device, torch.bfloat16)
    reset_launch_counts()
    o, hT = wkv6_chunked(r, k, v, lw, u, h0, chunk=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["wkv6_chunked"] == 1 and o.dtype == hT.dtype == torch.float32
    o_ref, h_ref = ref.wkv6_chunked_ref(r.float(), k.float(), v.float(), lw, u, h0, chunk=chunk)
    torch.testing.assert_close(o, o_ref, **WKV)
    torch.testing.assert_close(hT, h_ref, **WKV)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_repeats_bit_for_bit(dtype, cuda_device):
    """No atomics: two calls on the same inputs agree bit for bit (the LM's
    three-prefill gate rests on it)."""
    args = _wkv_inputs(4, 256, 64, 64, cuda_device, dtype)
    (o1, h1), (o2, h2) = wkv6_chunked(*args), wkv6_chunked(*args)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(h1, h2)


def test_wkv6_kernel_refuses_mixed_or_other_dtypes(cuda_device):
    r, k, v, lw, u, h0 = _wkv_inputs(1, 16, 2, 8, cuda_device, torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        wkv6_chunked(r, k, v.float(), lw, u, h0)
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        wkv6_chunked(r.half(), k.half(), v.half(), lw, u, h0)
    with pytest.raises(TypeError, match="logw"):
        wkv6_chunked(r, k, v, lw.bfloat16(), u, h0)


def test_ops_wkv6_passes_bf16_through_without_a_cast(cuda_device):
    """ops.wkv6 on the LM's bf16 r, k, v launches the kernel and nothing
    that copies them: the call allocates o (256 KB here) and the state
    (128 KB) and no float32 copy of r, k or v (256 KB each)."""
    B, S, H, K = 2, 128, 4, 64
    r, k, v, lw, u, h0 = _wkv_inputs(B, S, H, K, cuda_device, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launch_counts()
    o, hT = ops.wkv6(r, k, v, lw, u, h0)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    assert launch_counts()["wkv6_chunked"] == 1
    assert grew <= 4 * (o.numel() + hT.numel())
    torch.testing.assert_close(
        o, ref.wkv6_chunked_ref(r.float(), k.float(), v.float(), lw, u, h0)[0], **WKV)


def test_smoke_lm_on_card_matches_cpu(cuda_device):
    """The rwkv6-7b smoke config at kernel-q3 in float32: the card's
    prefill logits and greedy tokens against the plain versions on the CPU,
    with every projection and the prefill recurrence launched as kernels."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config("rwkv6-7b", "kernel-q3"), compute_dtype="float32")
    gpu = lm.prepack_params(lm.init_params(torch.Generator().manual_seed(0), cfg, cuda_device), cfg)
    cpu = lm.prepack_params(lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 80), generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    toks, _ = serve.generate(gpu, cfg, prompts.to(cuda_device), 90, 4)
    counts = launch_counts()
    assert counts["quant_epitome_matmul_blocks"] == 8 * cfg.n_layers * 4
    assert counts["wkv6_chunked"] == cfg.n_layers
    ref_toks, _ = serve.generate(cpu, cfg, prompts, 90, 4)
    assert torch.equal(toks.cpu(), ref_toks)


def test_smoke_lm_kernel_bf16_on_card_matches_cpu(cuda_device):
    """The rwkv6-7b smoke config at ``kernel`` (unquantized epitomes) in its
    own bf16: every projection through kernel #3's bf16 entry and the
    prefill recurrence through kernel #4, greedy tokens equal to the plain
    versions' on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = get_smoke_config("rwkv6-7b", "kernel")
    assert cfg.cdtype == torch.bfloat16
    gpu = lm.init_params(torch.Generator().manual_seed(0), cfg, cuda_device)
    cpu = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 80), generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    toks, _ = serve.generate(gpu, cfg, prompts.to(cuda_device), 90, 4)
    counts = launch_counts()
    assert counts["epitome_matmul_blocks"] == 8 * cfg.n_layers * 4
    assert counts["wkv6_chunked"] == cfg.n_layers
    assert counts["quant_epitome_matmul_blocks"] == 0
    ref_toks, _ = serve.generate(cpu, cfg, prompts, 90, 4)
    assert torch.equal(toks.cpu(), ref_toks)


def test_fold_repeats_bit_for_bit(cuda_device):
    """The fold gathers and sums, so it repeats exactly on the card (a
    scatter-add's atomics would not), and agrees with the CPU's."""
    spec, _, x, _, _ = _case(LM_SHAPES[2], 1024, cuda_device)
    for dtype, tol in ((torch.bfloat16, BF16), (torch.float32, TOL)):
        xd = x.to(dtype)
        first = ops.fold_rows(xd, spec)
        assert all(torch.equal(ops.fold_rows(xd, spec), first) for _ in range(10))
        torch.testing.assert_close(first.cpu().float(), ops.fold_rows(xd.cpu(), spec).float(),
                                   **tol)


def _quant_matmul_case(T, M, N, device, lead=()):
    g = torch.Generator().manual_seed(M + N + T)
    q = torch.randint(-127, 128, (M, N), generator=g, dtype=torch.int8)
    s = torch.rand(M // 256, N // 256, generator=g) * 9e-3 + 1e-3
    z = torch.round(torch.rand(M // 256, N // 256, generator=g) * 6 - 3)
    x = torch.randn(*lead, T, M, generator=g)
    return tuple(t.to(device) for t in (x, q, s, z))


@pytest.mark.parametrize("T,M,N", [(8, 256, 256), (7, 512, 768), (130, 1024, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_kernel(T, M, N, dtype, cuda_device):
    """Kernel #5 against its plain version on the card, through ops (rows
    padded to the row block and trimmed), in x's dtype."""
    x, q, s, z = _quant_matmul_case(T, M, N, cuda_device)
    x = x.to(dtype)
    reset_launch_counts()
    y = ops.quant_matmul(x, q, s, z)
    torch.cuda.synchronize()
    assert launch_counts()["quant_matmul"] == 1 and y.dtype == dtype
    torch.testing.assert_close(y.float(), ref.quant_matmul_ref(x, q, s, z).float(),
                               **(TOL if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("T", [32, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_around_the_decode_cut_over(T, dtype, cuda_device):
    """Kernel #5 on both sides of the cut-over between kernel #1's split-K
    decode loop (T <= 32) and its tensor-core loop: one launch, against the
    plain version."""
    x, q, s, z = _quant_matmul_case(T, 4096, 1024, cuda_device)
    x = x.to(dtype)
    reset_launch_counts()
    y = ops.quant_matmul(x, q, s, z)
    torch.cuda.synchronize()
    assert launch_counts()["quant_matmul"] == 1 and y.dtype == dtype
    torch.testing.assert_close(y.float(), ref.quant_matmul_ref(x, q, s, z).float(),
                               **(TOL if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_decode_rows_repeat_bit_for_bit(dtype, cuda_device):
    x, q, s, z = _quant_matmul_case(4, 14336, 1024, cuda_device)
    x = x.to(dtype)
    ys = [ops.quant_matmul(x, q, s, z) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(y, ys[0]) for y in ys)


def test_quant_matmul_leading_dims_and_refusals(cuda_device):
    from repro_torch.kernels.quant_matmul import quant_matmul
    x, q, s, z = _quant_matmul_case(5, 512, 256, cuda_device, lead=(2, 3))
    y = ops.quant_matmul(x, q, s, z)
    assert tuple(y.shape) == (2, 3, 5, 256)
    torch.testing.assert_close(y.cpu(), ops.quant_matmul(*(t.cpu() for t in (x, q, s, z))),
                               **TOL)
    x2 = x.reshape(-1, 512)
    with pytest.raises(ValueError, match="multiples of 256"):
        quant_matmul(x2[:, :384].contiguous(), q[:384], s, z)
    with pytest.raises(ValueError, match="scales/zeros"):
        quant_matmul(x2, q, s[:1], z[:1])
    with pytest.raises(ValueError, match="q is on cpu"):
        quant_matmul(x2, q.cpu(), s, z)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(x2, q.float(), s, z)


@pytest.mark.parametrize("T", [4, 256])
def test_quant_matmul_long_contraction_vs_float64(T, cuda_device):
    """At rwkv6-7b's longest contraction (M = 14336) and the reference
    test's code scales, kernel #5 stays within the reference's fp32
    tolerance of the float64 product and is no further from it than the
    plain version (cuBLAS float32)."""
    from repro_torch.core.quant import dequantize_packed
    from repro_torch.kernels.quant_matmul import quant_matmul
    x, q, s, z = _quant_matmul_case(T, 14336, 1024, cuda_device)
    exact = x.double() @ dequantize_packed(q, s, z, (256, 256)).double()
    y, plain = quant_matmul(x, q, s, z), ref.quant_matmul_ref(x, q, s, z)
    torch.testing.assert_close(y.double(), exact, **TOL)
    assert (y.double() - exact).abs().max() <= (plain.double() - exact).abs().max()


def test_wkv6_kernel_carries_h0_across_launches(cuda_device):
    """A chunked prefill's second chunk starts from the first chunk's hT:
    two launches of 64 tokens against one launch over both chunks (the
    rwkv6-7b shape, bf16 r, k, v), within the WKV tolerance."""
    r, k, v, lw, u, _ = _wkv_inputs(1, 128, 64, 64, cuda_device, torch.bfloat16)
    reset_launch_counts()
    o1, h1 = wkv6_chunked(r[:, :64], k[:, :64], v[:, :64], lw[:, :64], u, None, chunk=64)
    o2, h2 = wkv6_chunked(r[:, 64:].contiguous(), k[:, 64:].contiguous(), v[:, 64:].contiguous(),
                          lw[:, 64:].contiguous(), u, h1, chunk=64)
    o, h = wkv6_chunked(r, k, v, lw, u, None, chunk=64)
    torch.cuda.synchronize()
    assert launch_counts()["wkv6_chunked"] == 3
    torch.testing.assert_close(torch.cat([o1, o2], 1), o, **WKV)
    torch.testing.assert_close(h2, h, **WKV)


def _engine_sites(cfg):
    """Kernel #1 launches a forward: the epitomized int8 projections."""
    from repro_torch.models import lm
    return cfg.n_groups * sum(lc.is_epitome and lc.quant is not None and lc.mode == "kernel"
                              for lc in lm.lm_layer_configs(cfg).values())


@pytest.mark.parametrize("arch,page_size,chunk", [("rwkv6-7b", 0, 64), ("qwen2-72b", 16, 16),
                                                ("phi3.5-moe-42b-a6.6b", 16, 16)])
def test_smoke_engine_on_card(arch, page_size, chunk, cuda_device):
    """The engine at smoke size on the card (bf16, kernel-q3): K = 4 gives
    K = 1's tokens bit for bit, so does the reverse arrival order, greedy
    and sampled; every prefill and decode micro-step launches kernel #1 at
    each epitomized projection, every prefill (bucket or chunk) kernel #4
    once per RWKV layer."""
    from repro_torch.launch.engine import EngineConfig, Request
    rng = np.random.default_rng(0)
    lens = (5, 70, 13, 40, 9) if arch == "rwkv6-7b" else (6, 35, 11, 21, 9)
    reqs = [Request(prompt=tuple(rng.integers(0, 192, P).tolist()), max_new_tokens=4 + i,
                    temperature=0.8 if i % 2 else 0.0, seed=i) for i, P in enumerate(lens)]
    runs = []
    for k, order in ((1, range(5)), (4, range(5)), (4, range(4, -1, -1))):
        eng = EngineConfig(arch=arch, epitome="kernel-q3", smoke=True, capacity=2, max_len=96,
                           page_size=page_size, prefill_chunk=chunk, decode_block=k).build()
        reset_launch_counts()
        handles = {i: eng.submit(reqs[i]) for i in order}
        eng.drain()
        torch.cuda.synchronize()
        counts, st = launch_counts(), eng.stats
        # a MoE arch prefills every prompt whole (eng.chunk is 0)
        whole = [P for P in lens if not eng.chunk or P <= eng.chunk]
        prefills = len(whole) + st["prefill_chunks"]
        assert st["prefill_chunks"] == sum(-(-P // eng.chunk) for P in lens if P not in whole)
        assert counts["quant_epitome_matmul_blocks"] == \
            _engine_sites(eng.cfg) * (prefills + st["decode_micro_steps"])
        rwkv_layers = sum(kind == "rwkv" for kind, _ in eng.cfg.full_pattern) * eng.cfg.n_groups
        assert counts["wkv6_chunked"] == rwkv_layers * prefills
        runs.append({i: h.result().tokens for i, h in handles.items()})
    assert runs[0] == runs[1] == runs[2]


@functools.lru_cache(maxsize=1)
def _phi35_moe_layer():
    """One MoE layer at phi3.5-moe's width (E 16, d 4096, ff 6400, top 2),
    float32, drawn on the CPU from a seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("phi3.5-moe-42b-a6.6b", n_layers=1)
    return cfg, moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")


@pytest.mark.parametrize("T", [4, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dense_at_phi35_width_matches_cpu(dtype, T, cuda_device):
    """moe_dense at phi3.5-moe's width, one layer, card against CPU: the
    router picks the same experts, the output within the kernels'
    tolerance of its dtype."""
    import dataclasses
    from repro_torch.models import moe
    cfg0, cpu32 = _phi35_moe_layer()
    name = str(dtype).replace("torch.", "")
    cfg = dataclasses.replace(cfg0, param_dtype=name, compute_dtype=name)
    assert (cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k) == (16, 4096, 6400, 2)
    cpu = {k: (v if k == "router" else v.to(dtype)) for k, v in cpu32.items()}
    card = {k: v.to(cuda_device) for k, v in cpu.items()}
    x = torch.randn(2, T // 2, cfg.d_model, generator=torch.Generator().manual_seed(T)).to(dtype)
    _, e_card = moe._route(x.reshape(-1, cfg.d_model).to(cuda_device), card["router"], cfg)
    _, e_cpu = moe._route(x.reshape(-1, cfg.d_model), cpu["router"], cfg)
    assert torch.equal(e_card.cpu(), e_cpu)
    y = moe.moe_dense(card, x.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (2, T // 2, cfg.d_model)
    torch.testing.assert_close(y.cpu(), moe.moe_dense(cpu, x, cfg),
                               **(TOL if dtype == torch.float32 else BF16))


# -- training: the WKV backward kernel, folded_matmul, a train step ------------
def _wkv_bwd_case(B, S, H, K, dtype, state, dh, device, seed=0, logw=None):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g)
    r, k, v = (f(B, S, H, K).to(dtype) for _ in range(3))
    lw, u = -torch.exp(f(B, S, H, K) * 0.5), f(H, K) * 0.1
    if logw is not None:
        lw = torch.full((B, S, H, K), logw)
    h0 = f(B, H, K, K) * 0.5 if state else None
    do, dhT = f(B, S, H, K), (f(B, H, K, K) if dh else None)
    to = lambda t: None if t is None else t.to(device)
    return [to(t) for t in (r, k, v, lw, u, h0, do, dhT)]


@pytest.mark.parametrize("B,S,H,K,dtype,state,dh", [
    (2, 64, 2, 64, torch.float32, True, True), (2, 50, 2, 64, torch.bfloat16, True, False),
    (1, 37, 3, 12, torch.float32, True, True), (2, 256, 4, 64, torch.bfloat16, False, True),
    (1, 5, 1, 8, torch.float32, False, False)])
def test_wkv6_bwd_kernel_matches_plain_and_repeats(B, S, H, K, dtype, state, dh, cuda_device):
    """The backward kernel against wkv6_chunked_bwd_ref (the WKV gate),
    float32 and bf16 r, k, v, ragged S, K = 12, with and without h0 and
    dhT; one launch a call; three calls bit for bit."""
    from repro_torch.kernels.wkv6 import wkv6_chunked_bwd
    args = _wkv_bwd_case(B, S, H, K, dtype, state, dh, cuda_device)
    reset_launch_counts()
    outs = [wkv6_chunked_bwd(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert launch_counts()["wkv6_chunked_bwd"] == 3
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    assert all(t.dtype == torch.float32 for t in outs[0])
    for a, b in zip(outs[0], ref.wkv6_chunked_bwd_ref(*args)):
        torch.testing.assert_close(a, b, **WKV)


@pytest.mark.parametrize("B,S,H,K,dtype,logw", [
    (1, 128, 2, 64, torch.float32, -20.0), (2, 200, 2, 64, torch.bfloat16, -20.0),
    (2, 77, 3, 32, torch.bfloat16, None), (1, 150, 2, 16, torch.float32, None)])
def test_wkv6_bwd_kernel_strong_decay_and_narrow_heads(B, S, H, K, dtype, logw, cuda_device):
    """The chunked backward at log w = -20 (every factor e to a non-positive
    power: finite, within the WKV gate), and at K < 64 with a ragged last
    chunk; from h0 with dhT, three calls bit for bit."""
    from repro_torch.kernels.wkv6 import wkv6_chunked_bwd
    args = _wkv_bwd_case(B, S, H, K, dtype, True, True, cuda_device, seed=2, logw=logw)
    outs = [wkv6_chunked_bwd(*args) for _ in range(3)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    assert all(bool(torch.isfinite(t).all()) for t in outs[0])
    for a, b in zip(outs[0], ref.wkv6_chunked_bwd_ref(*args)):
        torch.testing.assert_close(a, b, **WKV)


def test_wkv6_autograd_on_card_launches_both_kernels(cuda_device):
    """ops.wkv6 under autograd: kernel #4 forward, the backward kernel once;
    bf16 r, k, v get bf16 gradients, the rest float32; against the CPU's
    plain gradient."""
    r, k, v, lw, u, h0, do, _ = _wkv_bwd_case(2, 50, 2, 16, torch.bfloat16, True, False,
                                              cuda_device, seed=1)
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, lw, u, h0)]
    reset_launch_counts()
    o, hT = ops.wkv6(*ins)
    (o * do).sum().backward()
    counts = launch_counts()
    assert counts["wkv6_chunked"] == 1 and counts["wkv6_chunked_bwd"] == 1
    assert [t.grad.dtype for t in ins] == [torch.bfloat16] * 3 + [torch.float32] * 3
    cpu = [t.detach().cpu().requires_grad_(True) for t in ins]
    oc, _ = ops.wkv6(*cpu)
    (oc * do.cpu()).sum().backward()
    for a, b in zip(ins, cpu):
        torch.testing.assert_close(a.grad.cpu().float(), b.grad.float(),
                                   **(WKV if a.dtype == torch.float32 else BF16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_matmul_repeats_bit_for_bit_on_card(dtype, cuda_device):
    """folded_matmul at rwkv6-7b's (4096, 14336) projection, forward and
    backward three times: the same bits (gathers, no scatter-add)."""
    from repro_torch.core.epitome import folded_matmul
    spec = EpitomeSpec(*LM_SHAPES[1])
    g = torch.Generator().manual_seed(2)
    x0 = torch.randn(512, spec.M, generator=g).to(cuda_device, dtype)
    E0 = (torch.randn(spec.m, spec.n, generator=g) / spec.M ** 0.5).to(cuda_device)
    dy = torch.randn(512, spec.N, generator=g).to(cuda_device, dtype)
    runs = []
    for _ in range(3):
        x, E = x0.clone().requires_grad_(True), E0.clone().requires_grad_(True)
        y = folded_matmul(x, E, spec)
        y.backward(dy)
        runs.append((y.detach(), x.grad, E.grad))
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))
    y_cpu = folded_matmul(x0.cpu(), E0.cpu(), spec)
    torch.testing.assert_close(runs[0][0].cpu(), y_cpu, **(TOL if dtype == torch.float32 else BF16))


def test_smoke_rwkv6_folded_q3_train_step_on_card_matches_cpu(cuda_device):
    """One make_train_step step of the rwkv6-7b smoke config at folded-q3 in
    float32 on the card: 2 x layers WKV forward launches (the remat
    recompute) and one backward a layer, twice from one state bit for bit.
    Against the CPU: the loss, the grad norm and every gradient leaf at the
    WKV gate (1e-3 + 1e-3 |ref|), and the AdamW step (lr 1e-2, no warm-up)
    on the CPU's gradients, its parameter change within 1e-3 lr of the
    CPU's.  The step is held on one set of gradients because Adam's first
    update g / (|g| + eps) is about +-lr per element: an element whose
    gradient lies within the devices' rounding of zero may take it in
    either sign, so the gradients are held leaf by leaf instead."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import loop, optimizer
    from repro_torch.train.data import SyntheticData
    from repro_torch.train.tree import leaves, tree_map
    cfg = dataclasses.replace(get_smoke_config("rwkv6-7b", "folded-q3"), compute_dtype="float32")
    opt = optimizer.AdamWConfig(lr=1e-2, warmup_steps=0)
    batch = SyntheticData(cfg.vocab, 80, 2, seed=1).batch(0)
    init = lambda device: loop.init_state(torch.Generator().manual_seed(0), cfg, opt,
                                          device=device)
    runs = []
    for _ in range(2):
        state = init(cuda_device)
        reset_launch_counts()
        state, m = loop.make_train_step(cfg, opt)(state, batch)
        counts = launch_counts()
        assert counts["wkv6_chunked"] == 2 * cfg.n_layers
        assert counts["wkv6_chunked_bwd"] == cfg.n_layers
        assert counts["quant_epitome_matmul_blocks"] == counts["epitome_matmul_blocks"] == 0
        runs.append((m, [t.detach().cpu() for t in leaves(state)]))
    (m1, s1), (m2, s2) = runs
    assert torch.equal(m1["loss"], m2["loss"]) and all(torch.equal(a, b) for a, b in zip(s1, s2))
    host, card = init("cpu"), init(cuda_device)
    h_loss, h_grads = loop.loss_and_grads(host["params"], batch, cfg)
    c_loss, c_grads = loop.loss_and_grads(
        card["params"], {k: v.to(cuda_device) for k, v in batch.items()}, cfg)
    assert torch.equal(c_loss, m1["loss"])
    torch.testing.assert_close(c_loss.cpu(), h_loss, rtol=1e-4, atol=1e-4)
    for a, b in zip(leaves(c_grads), leaves(h_grads)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)
    old = [p.detach().clone() for p in leaves(host["params"])]
    _, mh = loop.apply_grads(host, h_grads, opt)
    torch.testing.assert_close(m1["grad_norm"].cpu(), mh["grad_norm"], rtol=1e-3, atol=1e-4)
    loop.apply_grads(card, tree_map(lambda g: g.to(cuda_device), h_grads), opt)
    moved = 0.0
    for p0, a, b in zip(old, leaves(card["params"]), leaves(host["params"])):
        torch.testing.assert_close(a.detach().cpu() - p0, b.detach() - p0,
                                   rtol=0, atol=1e-3 * opt.lr)
        moved = max(moved, float((b.detach() - p0).abs().max()))
    assert moved > 0.5 * opt.lr


# -- Mamba: the selective-scan kernel, jamba smoke -------------------------------
SCAN = dict(rtol=2e-4, atol=2e-4)       # fp32, tests/test_kernels.py:17-18


def _scan_case(B, S, di, ds, device, seed=0, state=True):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g)
    dt = torch.nn.functional.softplus(f(B, S, di) - 1.0)
    A = -torch.exp(f(di, ds) * 0.5)
    ins = (dt, f(B, S, di), f(B, S, ds), f(B, S, ds), A, f(di), f(B, di, ds) if state else None)
    return tuple(None if t is None else t.to(device) for t in ins)


@pytest.mark.parametrize("B,S,di,ds,state", [
    (4, 256, 16384, 16, True), (2, 250, 1000, 16, False), (4, 1, 16384, 16, True),
    (1, 1, 512, 16, True), (3, 77, 300, 4, True), (1, 128, 16384, 16, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_matches_plain(B, S, di, ds, state, dtype, cuda_device):
    """The scan kernel against mamba_scan_ref on the same values (bf16
    inputs widened exactly), jamba's width, decode rows and the engine's
    batch-1 chunk among them."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    dt, x, Bm, Cm, A, D, h0 = _scan_case(B, S, di, ds, cuda_device, state=state)
    dt, x, Bm, Cm = (t.to(dtype) for t in (dt, x, Bm, Cm))
    before = mamba_scan.launches
    y, hT = mamba_scan(dt, x, Bm, Cm, A, D, h0)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    y_ref, h_ref = ref.mamba_scan_ref(dt, x, Bm, Cm, A, D, h0)
    torch.testing.assert_close(y, y_ref, **SCAN)
    torch.testing.assert_close(hT, h_ref, **SCAN)


def test_mamba_scan_kernel_splits_repeats_and_identity(cuda_device):
    """Bit for bit: 128 + 128 tokens carried through hT against one launch
    of 256; three launches; dt = 0 on the last 7 tokens leaves the state as
    it stood; bf16 inputs against float32 inputs of the same values."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    dt, x, Bm, Cm, A, D, h0 = _scan_case(2, 256, 4096, 16, cuda_device)
    y, hT = mamba_scan(dt, x, Bm, Cm, A, D, h0)
    ya, ha = mamba_scan(*(t[:, :128].contiguous() for t in (dt, x, Bm, Cm)), A, D, h0)
    yb, hb = mamba_scan(*(t[:, 128:].contiguous() for t in (dt, x, Bm, Cm)), A, D, ha)
    assert torch.equal(torch.cat([ya, yb], 1), y) and torch.equal(hb, hT)
    again = [mamba_scan(dt, x, Bm, Cm, A, D, h0) for _ in range(3)]
    assert all(torch.equal(a, y) and torch.equal(h, hT) for a, h in again)
    tail = dt.clone()
    tail[:, -7:] = 0.0
    _, h_tail = mamba_scan(tail, x, Bm, Cm, A, D, h0)
    _, h_before = mamba_scan(*(t[:, :-7].contiguous() for t in (tail, x, Bm, Cm)), A, D, h0)
    assert torch.equal(h_tail, h_before)
    bf = [t.bfloat16() for t in (dt, x, Bm, Cm)]
    yb16, hb16 = mamba_scan(*bf, A, D, h0)
    y32, h32 = mamba_scan(*(t.float() for t in bf), A, D, h0)
    assert torch.equal(yb16, y32) and torch.equal(hb16, h32)


@pytest.mark.parametrize("S", [1, 128])
def test_mamba_scan_kernel_batch_rows_equal_one_row_launches(S, cuda_device):
    """Bit for bit at jamba's width in bf16: each row of a 4-row launch
    against a 1-row launch of that row, as the engine mixes 4-row decode
    micro-steps with batch-1 chunks."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    dt, x, Bm, Cm, A, D, h0 = _scan_case(4, S, 16384, 16, cuda_device)
    dt, x, Bm, Cm = (t.bfloat16() for t in (dt, x, Bm, Cm))
    y, hT = mamba_scan(dt, x, Bm, Cm, A, D, h0)
    for r in range(4):
        y1, h1 = mamba_scan(*(t[r:r + 1].contiguous() for t in (dt, x, Bm, Cm)), A, D,
                            h0[r:r + 1].contiguous())
        assert torch.equal(y[r:r + 1], y1) and torch.equal(hT[r:r + 1], h1)


def test_mamba_scan_kernel_token_by_token_equals_one_launch(cuda_device):
    """Bit for bit at jamba's width in bf16: 8 one-token launches carried
    through hT (4 lanes a channel) against one launch of 8 tokens (2
    lanes), as the engine's decode steps continue its prefill chunks."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    dt, x, Bm, Cm, A, D, h0 = _scan_case(4, 8, 16384, 16, cuda_device)
    dt, x, Bm, Cm = (t.bfloat16() for t in (dt, x, Bm, Cm))
    y, hT = mamba_scan(dt, x, Bm, Cm, A, D, h0)
    h, ys = h0, []
    for t in range(8):
        yt, h = mamba_scan(*(u[:, t:t + 1].contiguous() for u in (dt, x, Bm, Cm)), A, D, h)
        ys.append(yt)
    assert torch.equal(torch.cat(ys, 1), y) and torch.equal(h, hT)


def test_mamba_scan_kernel_scalar_instance_gives_the_vector_bits(cuda_device):
    """A state 4 bytes off 16-byte alignment takes the scalar-access
    instance of the kernel: the same y and hT bits as the vector one."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    dt, x, Bm, Cm, A, D, h0 = _scan_case(2, 40, 4096, 16, cuda_device)
    y, hT = mamba_scan(dt, x, Bm, Cm, A, D, h0)
    off = torch.empty(h0.numel() + 1, device=cuda_device)[1:].view(h0.shape)
    off.copy_(h0)
    assert off.data_ptr() % 16 != 0
    y2, h2 = mamba_scan(dt, x, Bm, Cm, A, D, off)
    assert torch.equal(y, y2) and torch.equal(hT, h2)


def test_mamba_scan_ptxas_gate_holds_on_a_warm_cache(cuda_device):
    """chip_smoke.py's phase-14 ptxas gate in a process that builds
    nothing: every library already built, the nvcc logs read back from
    beside them list the vector instances, none spilling."""
    import importlib.util
    from pathlib import Path
    from repro_torch.kernels import _build
    _build.build_all()
    _build.build_log.clear()
    _build.build_all()
    assert set(_build.build_log) == set(_build.LIBRARIES)
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_gate", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ptxas = smoke.scan_ptxas(_build.build_log)
    assert sum("Lb1E" in k for k in ptxas) == 4


GRAD = dict(rtol=1e-3, atol=1e-3)       # sums of thousands of terms: the WKV gradient's gate
SCAN_GRADS = ("ddt", "dx", "dB", "dC", "dA", "dD", "dh0")


def _scan_grad_case(B, S, di, ds, device, dtype, state=True, dy=True, dhT=True, seed=0):
    """The scan's inputs (dt, x, B, C in ``dtype``) and the gradients of
    its outputs, dy (B, S, di) and dhT (B, di, ds), float32 or None."""
    dt, x, Bm, Cm, A, D, h0 = _scan_case(B, S, di, ds, device, seed=seed, state=state)
    g = torch.Generator().manual_seed(seed + 1)
    gy = torch.randn(B, S, di, generator=g).to(device) if dy else None
    gh = torch.randn(B, di, ds, generator=g).to(device) if dhT else None
    return [t.to(dtype) for t in (dt, x, Bm, Cm)] + [A, D, h0], gy, gh


def _hold_scan_grads(got, want):
    """ddt, dx and dh0 at the kernel gate, the sums over channels or tokens
    (dA, dD, dB, dC) at the WKV gradient's."""
    for name, a, b in zip(SCAN_GRADS, got, want):
        tol = SCAN if name in ("ddt", "dx", "dh0") else GRAD
        torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,S,di,ds,state,dy,dhT", [
    (8, 256, 16384, 16, False, True, False),   # jamba's training step
    (2, 250, 1000, 16, True, True, True),      # ragged S and di
    (4, 1, 4096, 16, True, True, True),        # one token
    (3, 77, 300, 4, True, False, True),        # 4 states, no dy
    (1, 40, 128, 16, True, True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_bwd_kernel(B, S, di, ds, state, dy, dhT, dtype, cuda_device):
    """The scan's gradient kernel, one launch, against its plain version."""
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd
    ins, gy, gh = _scan_grad_case(B, S, di, ds, cuda_device, dtype, state, dy, dhT)
    before = mamba_scan_bwd.launches
    got = mamba_scan_bwd(*ins, gy, gh)
    torch.cuda.synchronize()
    assert mamba_scan_bwd.launches == before + 1
    assert all(t.dtype == torch.float32 for t in got)
    _hold_scan_grads(got, ref.mamba_scan_bwd_ref(*ins, gy, gh))


def test_mamba_scan_bwd_repeats_and_splits_bit_for_bit(cuda_device):
    """Three launches give the same bits; a scan split at token 128 (the
    second half from the forward kernel's state, the first given the
    second's dh0) gives one launch's ddt, dx, dB, dC and dh0 bit for bit,
    and dA and dD, added in another order, within the gate; MambaScan's
    backward on the card is one launch of the kernel."""
    from repro_torch.kernels.mamba_scan import MambaScan, mamba_scan, mamba_scan_bwd
    ins, gy, gh = _scan_grad_case(2, 256, 4096, 16, cuda_device, torch.bfloat16)
    dt, x, Bm, Cm, A, D, h0 = ins
    one = mamba_scan_bwd(*ins, gy, gh)
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(mamba_scan_bwd(*ins, gy, gh), one))
    cut = lambda lo, hi, *ts: [t[:, lo:hi].contiguous() for t in ts]
    _, ha = mamba_scan(*cut(0, 128, dt, x, Bm, Cm), A, D, h0)
    late = mamba_scan_bwd(*cut(128, 256, dt, x, Bm, Cm), A, D, ha,
                          gy[:, 128:].contiguous(), gh)
    early = mamba_scan_bwd(*cut(0, 128, dt, x, Bm, Cm), A, D, h0, gy[:, :128].contiguous(),
                           late[6])
    for i in range(4):
        assert torch.equal(torch.cat([early[i], late[i]], 1), one[i]), SCAN_GRADS[i]
    assert torch.equal(early[6], one[6])
    for i in (4, 5):
        torch.testing.assert_close(early[i] + late[i], one[i], **GRAD)
    req = [t.clone().requires_grad_(True) for t in ins]
    before = mamba_scan_bwd.launches
    y, hT = MambaScan.apply(*req, 128)
    grads = torch.autograd.grad((y * gy).sum() + (hT * gh).sum(), req)
    assert mamba_scan_bwd.launches == before + 1
    for a, b, t in zip(grads, one, ins):
        assert a.dtype == t.dtype and torch.equal(a, b.to(t.dtype))


def _autograd_scan_grads(ins, gy, gh):
    """The gradient by autograd through the plain forward (float32 copies
    of the inputs: the plain versions read bf16 as these values; a zero
    state for none), in SCAN_GRADS order."""
    B, _, di = ins[0].shape
    ds = ins[2].shape[-1]
    h0 = ins[6]
    req = [t.detach().to(torch.float32, copy=True).requires_grad_(True) for t in ins[:6]] + [
        (torch.zeros(B, di, ds, device=ins[0].device) if h0 is None else h0)
        .detach().clone().requires_grad_(True)]
    y, hT = ref.mamba_scan_ref(*req)
    out = (0.0 if gy is None else (y * gy).sum()) + (0.0 if gh is None else (hT * gh).sum())
    grads = torch.autograd.grad(out, req, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(grads, req)]


# ragged edges of the gradient's kernel (64 channels a block, a stored
# state every 8 tokens, 16-token tiles): ds 1, 5, 16; di one off the
# channel tile each way and a multiple of 8 that is not (the vector
# instance's zero-filled chunks); S 0, 1, 7, 9 and 17; a long scan
SCAN_BWD_RAGGED = [
    (2, 40, 128, 1), (2, 40, 128, 5), (2, 40, 128, 16),
    (2, 40, 63, 16), (2, 40, 65, 16), (2, 40, 72, 16),
    (2, 0, 128, 16), (2, 1, 128, 16), (2, 7, 128, 16), (2, 9, 128, 16), (2, 17, 128, 16),
    (1, 1000, 256, 16)]


@pytest.mark.parametrize("B,S,di,ds", SCAN_BWD_RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_bwd_kernel_ragged_edges(B, S, di, ds, dtype, cuda_device):
    """The gradient's kernel with a state, dy and dhT at ragged ds, di and
    S, one launch, against its plain version and against autograd of the
    plain forward; three launches bit for bit."""
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd
    ins, gy, gh = _scan_grad_case(B, S, di, ds, cuda_device, dtype, seed=S + di + ds)
    got = mamba_scan_bwd(*ins, gy, gh)
    torch.cuda.synchronize()
    assert [tuple(t.shape) for t in got] == [(B, S, di), (B, S, di), (B, S, ds), (B, S, ds),
                                            (di, ds), (di,), (B, di, ds)]
    _hold_scan_grads(got, ref.mamba_scan_bwd_ref(*ins, gy, gh))
    _hold_scan_grads(got, _autograd_scan_grads(ins, gy, gh))
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(mamba_scan_bwd(*ins, gy, gh), got))


@pytest.mark.parametrize("cut", [1, 7, 8, 9, 128])
def test_mamba_scan_bwd_splits_bit_for_bit_at_any_cut(cut, cuda_device):
    """A scan split at ``cut`` tokens (inside a window, at its edge, past
    it, at a tile's), the second half from the forward kernel's state and
    the first given the second's dh0, against one launch: ddt, dx, dB, dC
    and dh0 bit for bit, dA and dD (their halves added in another order)
    within the gate."""
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
    ins, gy, gh = _scan_grad_case(2, 256, 4096, 16, cuda_device, torch.bfloat16, seed=cut)
    dt, x, Bm, Cm, A, D, h0 = ins
    one = mamba_scan_bwd(*ins, gy, gh)
    part = lambda lo, hi, *ts: [t[:, lo:hi].contiguous() for t in ts]
    _, ha = mamba_scan(*part(0, cut, dt, x, Bm, Cm), A, D, h0)
    late = mamba_scan_bwd(*part(cut, 256, dt, x, Bm, Cm), A, D, ha, *part(cut, 256, gy), gh)
    early = mamba_scan_bwd(*part(0, cut, dt, x, Bm, Cm), A, D, h0, *part(0, cut, gy), late[6])
    for i in range(4):
        assert torch.equal(torch.cat([early[i], late[i]], 1), one[i]), SCAN_GRADS[i]
    assert torch.equal(early[6], one[6])
    for i in (4, 5):
        torch.testing.assert_close(early[i] + late[i], one[i], **GRAD)


@pytest.mark.parametrize("B,S,di", [
    (8, 256, 16384), (2, 250, 1000), (4, 1, 4096), (3, 77, 300), (1, 40, 128)]
    + [(B, S, di) for B, S, di, _ in SCAN_BWD_RAGGED])
def test_mamba_scan_bwd_scratch_is_the_cost_models(B, S, di, cuda_device):
    """The C entry's scratch (mamba_scan_bwd_scratch) is what
    ``cost.scan_bwd_scratch`` predicts, at every tested shape."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd_scratch_bytes
    assert mamba_scan_bwd_scratch_bytes(B, S, di) == cost.scan_bwd_scratch(B, S, di)


def test_mamba_scan_bwd_ptxas_gate_holds_on_a_warm_cache(cuda_device):
    """chip_smoke.py's phase 14 (e) gate in a process that builds nothing:
    the nvcc log read back from beside the built library lists the four
    instances of the gradient's main kernel, none spilling, each within
    the registers of two 256-thread blocks an SM; and each instance runs
    two blocks (16 warps) an SM."""
    import importlib.util
    from pathlib import Path
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd_occupancy
    _build.build_all()
    _build.build_log.clear()
    _build.build_all()
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bwd_gate", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert len(smoke.scan_bwd_ptxas(_build.build_log)) == 4
    for bf16 in (False, True):
        for vec in (False, True):
            occ = mamba_scan_bwd_occupancy(bf16, vec)
            assert occ["threads"] == 256 and occ["blocks_per_sm"] >= 2, (bf16, vec, occ)


def test_smoke_jamba_train_step_on_card_matches_cpu(cuda_device):
    """One loss_and_grads of the jamba smoke config (Mamba, attention, MoE)
    at folded-q3 in float32 on the card: 2 forward scan launches (the remat
    recompute) and one of its gradient a Mamba layer, no kernel #1 or #3;
    the loss and every gradient leaf against the CPU at the WKV gradient's
    gate, and twice from one state bit for bit."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train.data import SyntheticData
    from repro_torch.train.tree import leaves
    cfg = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b", "folded-q3"),
                              compute_dtype="float32")
    mamba = sum(kind == "mamba" for kind, _ in cfg.full_pattern) * cfg.n_groups
    batch = SyntheticData(cfg.vocab, 40, 2, seed=1).batch(0)
    params = lambda device: lm.init_params(torch.Generator().manual_seed(0), cfg, device)
    runs = []
    for _ in range(2):
        reset_launch_counts()
        loss, grads = loop.loss_and_grads(
            params(cuda_device), {k: v.to(cuda_device) for k, v in batch.items()}, cfg)
        counts = launch_counts()
        assert counts["mamba_scan"] == 2 * mamba and counts["mamba_scan_bwd"] == mamba
        assert counts["quant_epitome_matmul_blocks"] == counts["epitome_matmul_blocks"] == 0
        runs.append((loss, [g.cpu() for g in leaves(grads)]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    h_loss, h_grads = loop.loss_and_grads(params("cpu"), batch, cfg)
    torch.testing.assert_close(runs[0][0].cpu(), h_loss, rtol=1e-4, atol=1e-4)
    for a, b in zip(runs[0][1], leaves(h_grads)):
        torch.testing.assert_close(a, b, **GRAD)


def test_smoke_jamba_on_card_matches_cpu(cuda_device):
    """The jamba smoke config (Mamba, attention, MoE and dense FFNs) at
    kernel-q3 in float32: the card's prefill and decode logits and greedy
    tokens against the plain versions on the CPU, with the scan launched
    once per Mamba layer a forward."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b", "kernel-q3"),
                              compute_dtype="float32")
    gpu = lm.prepack_params(lm.init_params(torch.Generator().manual_seed(0), cfg, cuda_device), cfg)
    cpu = lm.prepack_params(lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    mamba = sum(kind == "mamba" for kind, _ in cfg.full_pattern) * cfg.n_groups
    reset_launch_counts()
    toks, _ = serve.generate(gpu, cfg, prompts.to(cuda_device), 50, 4)
    assert launch_counts()["mamba_scan"] == mamba * 4
    ref_toks, _ = serve.generate(cpu, cfg, prompts, 50, 4)
    assert torch.equal(toks.cpu(), ref_toks)
    with torch.no_grad():
        lg, _ = lm.prefill(gpu, prompts.to(cuda_device), lm.init_decode_state(cfg, 2, 50,
                                                                               cuda_device), cfg)
        lc, _ = lm.prefill(cpu, prompts, lm.init_decode_state(cfg, 2, 50, "cpu"), cfg)
    scale = max(1.0, float(lc.abs().max()))
    assert float((lg.cpu() - lc).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("ffn", ["moe", "dense"])
def test_smoke_jamba_engine_on_card(ffn, cuda_device):
    """jamba smoke's engine on the card (bf16, kernel-q3), with its MoE FFNs
    (whole prefills) and without them (chunks across the scan's windows):
    K = 4 gives K = 1's tokens bit for bit, so does the reverse arrival
    order; the scan launches once per Mamba layer a prefill, chunk or
    decode micro-step."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.engine import EpimEngine, Request
    from repro_torch.models import lm
    over = {} if ffn == "moe" else dict(ffn_pattern=("dense", "none") * 4, mamba_chunk=8)
    cfg = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b", "kernel-q3"), **over)
    params = lm.prepack_params(lm.init_params(torch.Generator().manual_seed(0), cfg,
                                              cuda_device), cfg)
    rng = np.random.default_rng(0)
    lens = (6, 35, 11, 21, 9)
    reqs = [Request(prompt=tuple(rng.integers(0, 192, P).tolist()), max_new_tokens=4 + i,
                    temperature=0.8 if i % 2 else 0.0, seed=i) for i, P in enumerate(lens)]
    mamba = sum(kind == "mamba" for kind, _ in cfg.full_pattern) * cfg.n_groups
    runs = []
    for k, order in ((1, range(5)), (4, range(5)), (4, range(4, -1, -1))):
        eng = EpimEngine(cfg, params, capacity=2, max_len=96, page_size=16, prefill_chunk=8,
                         decode_block=k, device=cuda_device)
        reset_launch_counts()
        handles = {i: eng.submit(reqs[i]) for i in order}
        eng.drain()
        torch.cuda.synchronize()
        counts, st = launch_counts(), eng.stats
        whole = [P for P in lens if not eng.chunk or P <= eng.chunk]
        assert (st["prefill_chunks"] > 0) == (ffn == "dense")
        prefills = len(whole) + st["prefill_chunks"]
        assert counts["mamba_scan"] == mamba * (prefills + st["decode_micro_steps"])
        assert counts["quant_epitome_matmul_blocks"] == \
            _engine_sites(cfg) * (prefills + st["decode_micro_steps"])
        runs.append({i: h.result().tokens for i, h in handles.items()})
    assert runs[0] == runs[1] == runs[2]


# -- the autotuner on the card ------------------------------------------------------------
def test_wall_timer_on_card_rises_with_work(cuda_device):
    from repro_torch.kernels.autotune import wall_timer
    a = torch.randn(512, 512, device=cuda_device)
    b = torch.randn(4096, 4096, device=cuda_device)
    small = wall_timer(lambda: a @ a, 5)
    large = wall_timer(lambda: b @ b, 5)
    assert 0 < small < float("inf") and 0 < large < float("inf")
    assert large > small


def _tune_shapes():
    from repro_torch.pim.plan import auto_plan
    out = []
    for arch, T in (("tiny-resnet", 64), ("rwkv6-7b-smoke", 4)):
        spec = next(s for s in auto_plan(arch, weight_bits=3).specs() if s is not None)
        out.append((arch, spec, T))
    return out


@pytest.mark.parametrize("case", range(2), ids=["tiny-resnet", "rwkv6-7b-smoke"])
def test_tune_on_card_timed_then_cache(case, cuda_device, tmp_path):
    from repro_torch.kernels import autotune
    _, spec, T = _tune_shapes()[case]
    r1 = autotune.tune(spec, 3, T, grid="default", cache_dir=str(tmp_path))
    assert r1.source == "timed" and r1.tuned_us <= r1.heuristic_us
    assert r1.bit_identical and r1.backend == "torch-cuda" and not r1.skipped
    reset_launch_counts()
    r2 = autotune.tune(spec, 3, T, grid="default", cache_dir=str(tmp_path))
    assert r2.source == "cache" and r2.record() == r1.record()
    assert not any(launch_counts().values())


def test_tuned_tiny_plan_logits_equal_untuned_on_card(cuda_device, tmp_path):
    """At the inventory's input (32 x 32, so every layer runs the rows the
    tuner measured), a plan whose winners are all bit-identical serves the
    untuned plan's logits bit for bit.  Bit identity is measured at the
    tuned T only: at 16 x 16 inputs (a quarter of the rows) the same plans'
    logits differed by about 1e-4 on an H100."""
    from repro_torch.configs import get_resnet
    from repro_torch.kernels.autotune import tune_plan
    from repro_torch.pim.plan import auto_plan
    plan = auto_plan("tiny-resnet", weight_bits=3, mode="kernel")
    tuned = tune_plan(plan, t=2, grid="default", cache_dir=str(tmp_path))
    rec = tuned.provenance["tuned_blocks"]
    assert rec and all(r["source"] in ("timed", "cache") for r in rec.values())
    assert all(r["bit_identical"] for r in rec.values())
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    base = get_resnet("tiny-resnet", plan=plan, device=cuda_device)
    base.init(torch.Generator().manual_seed(0)).prepack()
    model = get_resnet("tiny-resnet", plan=tuned, device=cuda_device)
    model.init(torch.Generator().manual_seed(0)).prepack()
    with torch.no_grad():
        reset_launch_counts()
        y = model.apply(x)
        counts = launch_counts()
        fused = sum(1 for r in rec.values() if r["fused_fold"])
        assert counts["quant_epitome_matmul_fused_fold"] == fused
        assert counts["quant_epitome_matmul_blocks"] == len(rec) - fused
        assert torch.equal(y, base.apply(x))


# -- sharded serving on a (1, 1) NCCL mesh ------------------------------------------------
def _rwkv_smoke_plan():
    from repro_torch.pim.plan import auto_plan, legalize_plan
    return legalize_plan(auto_plan("rwkv6-7b-smoke", target_cr=2.0, weight_bits=3,
                                   mode="kernel"), mesh_shape={"data": 1, "model": 1})


def test_smoke_rwkv_plan_on_a_one_card_mesh_bit_identical(cuda_device):
    """A plan's codes laid out on a (1, 1) NCCL mesh serve the logits and
    greedy tokens of the same plan without a mesh, bit for bit, with as
    many launches of kernels #1 and #4."""
    from repro_torch.core.layers import Sharded
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.serve import build_model, generate
    from repro_torch.models import lm
    from repro_torch.models.common import set_mesh
    plan = _rwkv_smoke_plan()
    cfg, params = build_model("rwkv6-7b", "off", True, 0, cuda_device, plan=plan)
    prompts = torch.randint(0, cfg.vocab, (2, 8), device=cuda_device,
                            generator=torch.Generator(cuda_device).manual_seed(0))

    def run(p, mesh=None):
        with torch.no_grad():
            logits, _ = lm.prefill(p, prompts, lm.init_decode_state(
                cfg, 2, 17, cuda_device, mesh=mesh), cfg)
        reset_launch_counts()
        toks, _ = generate(p, cfg, prompts, 17, 8)
        return logits, toks, dict(launch_counts())

    ref = run(params)
    try:
        mesh = tmesh.mesh_for_plan(plan, 1, 1, cuda_device)
        assert torch.distributed.get_backend() == "nccl"
        set_mesh(mesh)
        sharded = lm.prepack_params(params, cfg, mesh=mesh)
        assert isinstance(sharded["groups"][0]["L0"]["mixer"]["wr"]["Eq"], Sharded)
        got = run(sharded, mesh)
    finally:
        tmesh.destroy_world()
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])
    assert got[2] == ref[2] and ref[2]["quant_epitome_matmul_blocks"] > 0
    assert ref[2]["wkv6_chunked"] > 0


def test_engine_config_mesh_on_card_equals_no_mesh(cuda_device):
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.engine import EngineConfig, Request
    g = torch.Generator().manual_seed(3)
    reqs = [Request(prompt=torch.randint(0, 192, (P,), generator=g).tolist(),
                    max_new_tokens=6) for P in (5, 9, 17)]

    def serve(mesh):
        eng = EngineConfig(arch="rwkv6-7b", epitome="kernel-q3", smoke=True, mesh=mesh,
                           capacity=2, max_len=32, decode_block=4, device="cuda").build()
        for r in reqs:
            eng.submit(r)
        return [c.tokens for c in eng.drain()], eng.mesh

    ref, none = serve(None)
    try:
        got, mesh = serve("1,1")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1, "model": 1}
    finally:
        tmesh.destroy_world()
    assert none is None and got == ref


def test_moe_dispatch_over_nccl_matches_dense(cuda_device):
    """One expert on a (1, 1) NCCL mesh: the dispatch path's all_to_all and
    all_gather run on the card, within rel 1e-4 of the dense path."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import moe
    from repro_torch.models.common import set_mesh
    cfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"), n_experts=1, top_k=1,
                              capacity_factor=8.0, compute_dtype="float32",
                              param_dtype="float32")
    params = moe.init_moe(torch.Generator(cuda_device).manual_seed(0), cfg, cuda_device)
    x = torch.randn(4, 16, cfg.d_model, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    try:
        set_mesh(tmesh.make_host_mesh(1, 1, cuda_device))
        with torch.no_grad():
            y_disp = moe.moe_dispatch(params, x, cfg)
            y_dense = moe.moe_dense(params, x, cfg)
    finally:
        tmesh.destroy_world()
    assert float((y_disp - y_dense).abs().max()) <= 1e-4 * float(y_dense.abs().max())


# -- training on a (1, 1) NCCL mesh ----------------------------------------------------
def _mesh_train_setup():
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import loop, optimizer
    from repro_torch.train.data import SyntheticData
    cfg = get_smoke_config("rwkv6-7b", "folded-q3")
    opt = optimizer.AdamWConfig(lr=1e-2, warmup_steps=0, moments_dtype="int8")
    tc = loop.TrainConfig(grad_accum=2, compress_grads=True)
    return cfg, opt, tc, SyntheticData(cfg.vocab, 80, 4, seed=1)


def test_smoke_train_step_on_a_one_card_mesh_bit_identical(cuda_device):
    """A train step of the rwkv6-7b smoke config (folded-q3, bf16, int8
    moments, compressed gradients, 2 microbatches) on a (1, 1) NCCL mesh,
    the state laid out by ``init_state(mesh=)``: the loss, every gradient
    and the new state bit for bit against no mesh, with as many launches of
    kernels #4 and #4b."""
    from repro_torch.core.layers import Sharded, unshard
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.common import set_mesh
    from repro_torch.train import loop
    from repro_torch.train.tree import leaves
    cfg, opt, tc, data = _mesh_train_setup()
    batch = {k: v.to(cuda_device) for k, v in data.batch(0).items()}

    def step(mesh=None):
        st = loop.init_state(torch.Generator(cuda_device).manual_seed(0), cfg, opt, tc,
                             cuda_device, mesh=mesh)
        reset_launch_counts()
        loss, grads = loop.loss_and_grads(st["params"], batch, cfg, tc)
        counts = dict(launch_counts())
        loop.apply_grads(st, grads, opt, tc)
        return loss, leaves(grads), [unshard(t) for t in leaves(st)], counts, st

    ref = step()
    try:
        mesh = tmesh.make_host_mesh(1, 1, cuda_device)
        assert torch.distributed.get_backend() == "nccl"
        set_mesh(mesh)
        got = step(mesh)
        assert isinstance(got[4]["params"]["embed"], Sharded)
    finally:
        tmesh.destroy_world()
    assert torch.equal(ref[0], got[0])
    assert all(torch.equal(a, b) for a, b in zip(ref[1], got[1]))
    assert all(torch.equal(a, b) for a, b in zip(ref[2], got[2]))
    assert got[3] == ref[3] and ref[3]["wkv6_chunked"] == 2 * 2 * cfg.n_layers
    assert ref[3]["wkv6_chunked_bwd"] == 2 * cfg.n_layers


def test_restore_with_shardings_on_a_one_card_mesh(cuda_device, tmp_path):
    """A mesh run's checkpoint (async, step 2) restored with
    ``shardings=loop.state_specs`` into a fresh state on the (1, 1) NCCL
    mesh, and into one with no mesh: both take steps 2-3 to the straight
    run's state bit for bit."""
    from repro_torch.core.layers import unshard
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.common import set_mesh
    from repro_torch.train import loop
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import leaves
    cfg, opt, tc, data = _mesh_train_setup()
    tc = loop.TrainConfig(grad_accum=2, compress_grads=True, checkpoint_every=2)
    step = loop.make_train_step(cfg, opt, tc)
    quiet = lambda *a: None
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), keep=1)
    fresh = lambda mesh: loop.init_state(torch.Generator(cuda_device).manual_seed(1), cfg,
                                         opt, tc, cuda_device, mesh=mesh)
    try:
        mesh = tmesh.make_host_mesh(1, 1, cuda_device)
        set_mesh(mesh)
        st = loop.init_state(torch.Generator(cuda_device).manual_seed(0), cfg, opt, tc,
                             cuda_device, mesh=mesh)
        st, _ = loop.train_loop(st, step, data, 2, ckpt=ckpt, train_cfg=tc, log=quiet)
        st, rest = loop.train_loop(st, step, data, 4, train_cfg=tc, log=quiet)
        straight = [unshard(t).clone() for t in leaves(st)]
        target = fresh(mesh)
        at, restored = ckpt.restore(target, shardings=loop.state_specs(cfg, target))
        restored, again = loop.train_loop(restored, step, data, 4, train_cfg=tc, log=quiet)
        on_mesh = [unshard(t) for t in leaves(restored)]
    finally:
        tmesh.destroy_world()
    _, one = ckpt.restore(fresh(None))
    one, again_one = loop.train_loop(one, step, data, 4, train_cfg=tc, log=quiet)
    assert at == 2 and again["loss"] == rest["loss"] == again_one["loss"]
    assert all(torch.equal(a, b) for a, b in zip(straight, on_mesh))
    assert all(torch.equal(a, b) for a, b in zip(straight, leaves(one)))
