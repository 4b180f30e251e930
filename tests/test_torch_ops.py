"""Port parity: the ops wrappers of repro_torch.kernels (block picks, tables,
padding, the plain version of each kernel) against the JAX reference — its
jnp oracles, and its Pallas kernels run in interpret mode.

On this jax the reference kernels look up ``pltpu.TPUCompilerParams``, which
jax 0.9 renamed ``CompilerParams``; the ``pallas_compat`` fixture aliases it
for one test at a time and clears jax's caches after, so nothing traced
under the alias reaches the reference package's own tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import epitome as jep
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import epitome as tep
from repro_torch.core import quant as tq
from repro_torch.kernels import launch_counts, ops as tops, ref as tref
from repro_torch.kernels.epitome_matmul import epitome_matmul_blocks
from repro_torch.kernels.quant_epitome_matmul import (
    quant_epitome_matmul_blocks, quant_epitome_matmul_fused_fold)

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

FP32 = dict(rtol=2e-4, atol=2e-4)       # tests/test_kernels.py:17-18
BLOCK = dict(rtol=1e-4, atol=1e-4)      # the block contract, tests/test_kernels.py:182

SPECS = [
    (512, 512, 256, 512, 128, 256),     # identity cols
    (512, 768, 256, 256, 128, 256),     # wrap
    (1024, 1024, 512, 512, 128, 256),   # spread (snapped) col offsets
    (1152, 128, 288, 128, 256, 128),    # ragged m, pack bk 32
    (2048, 1000, 2000, 256, 256, 256),  # fc: m=2000, pack bk 16, N trimmed
    (512, 512, 251, 256, 128, 256),     # prime m
    (576, 64, 256, 64, 256, 64),        # layer1 conv2
]


@pytest.fixture
def pallas_compat(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    yield
    jax.clear_caches()


def _case(args, T=10, seed=0):
    rng = np.random.default_rng(seed)
    js, ts = jep.EpitomeSpec(*args), tep.EpitomeSpec(*args)
    E = (rng.standard_normal((js.m, js.n)) / np.sqrt(js.M)).astype(np.float32)
    x = rng.standard_normal((T, js.M)).astype(np.float32)
    return js, ts, E, x


def test_block_picks_equal():
    for T in list(range(1, 300)) + [1568, 6272, 25088, 100352, 196, 97]:
        assert tops._pick_bt(T) == jops._pick_bt(T), T
    for m in list(range(1, 600)) + [1000, 1024, 2000, 2304, 4608]:
        assert tops._pick_bk(m) == jops._pick_bk(m), m
        for tile in (16, 64, 256):
            assert tops._pick_bk_quant(m, tile) == jops._pick_bk_quant(m, tile), (m, tile)
    assert tops._pick_bk_quant(2000, 256) == 16 and tops._pick_bk_quant(288, 256) == 32


@pytest.mark.parametrize("args", SPECS)
def test_tables_and_pack_blocks_equal(args):
    js, ts, _, _ = _case(args)
    np.testing.assert_array_equal(tops.kernel_col_blocks(ts), jops.kernel_col_blocks(js))
    for bn in (64, 128, 256):
        if bn <= ts.bn and ts.bn % bn == 0:
            assert tops.col_blocks_splittable(ts, bn) == jops.col_blocks_splittable(js, bn)
            if tops.col_blocks_splittable(ts, bn):
                np.testing.assert_array_equal(tops.kernel_col_blocks(ts, bn),
                                              jops.kernel_col_blocks(js, bn))
    for bits in (3, 8):
        assert tops.pack_blocks(ts, tq.QuantConfig(bits=bits)) == \
            jops.pack_blocks(js, jq.QuantConfig(bits=bits))
    assert tops.pack_blocks(ts, tq.QuantConfig(), (32, 16, ts.bn)) == \
        jops.pack_blocks(js, jq.QuantConfig(), (32, 16, js.bn)) == (16, ts.bn)


@pytest.mark.parametrize("args", SPECS)
def test_fold_rows_and_padding(args):
    js, ts, _, x = _case(args, T=13)
    np.testing.assert_allclose(tops.fold_rows(torch.from_numpy(x), ts).numpy(),
                               np.asarray(jops.fold_rows(jnp.asarray(x), js)),
                               rtol=1e-6, atol=1e-6)
    xp, bt = tops._pad_rows(torch.from_numpy(x))
    xj, btj = jops._pad_rows(jnp.asarray(x))
    assert bt == btj and xp.shape == xj.shape
    a, b = tops._pad_contraction(torch.ones(3, 251), torch.ones(251, 4), 128)
    assert a.shape == (3, 256) and b.shape == (256, 4) and float(a[:, 251:].abs().sum()) == 0


@pytest.mark.parametrize("args", SPECS)
def test_epitome_matmul_vs_oracle(args):
    js, ts, E, x = _case(args)
    y = tops.epitome_matmul(torch.from_numpy(x), torch.from_numpy(E), ts)
    ref = jref.epitome_matmul_blocks_ref(jops.fold_rows(jnp.asarray(x), js),
                                         jnp.asarray(E), jops.kernel_col_blocks(js), js.bn)
    assert y.shape == (10, js.N)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref)[:, :js.N], **FP32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("args", SPECS)
def test_quant_epitome_matmul_vs_oracle(args, fused):
    js, ts, E, x = _case(args)
    jp = jops.pack_epitome(jnp.asarray(E), js, jq.QuantConfig(bits=3))
    tp = tops.pack_epitome(torch.from_numpy(E), ts, tq.QuantConfig(bits=3))
    np.testing.assert_array_equal(tp.q.numpy(), np.asarray(jp.q))
    y = tops.quant_epitome_matmul(torch.from_numpy(x).reshape(2, 5, -1), None, ts,
                                  packed=tp, fused_fold=fused)
    q = jnp.pad(jp.q, ((0, (-js.m) % jp.bk), (0, 0)))
    folded = jnp.pad(jops.fold_rows(jnp.asarray(x), js), ((0, 0), (0, (-js.m) % jp.bk)))
    ref = jref.quant_epitome_matmul_blocks_ref(folded, q, jp.scales, jp.zeros,
                                               jops.kernel_col_blocks(js), jp.bk, jp.bn)
    assert y.shape == (2, 5, js.N)
    np.testing.assert_allclose(y.reshape(10, -1).numpy(), np.asarray(ref)[:, :js.N], **BLOCK)


@pytest.mark.parametrize("args", [SPECS[1], SPECS[3], SPECS[5]])
def test_fused_fold_plain_version_matches_blocks(args):
    """The fused-fold plain version against fold_rows + the blocks plain
    version on the same codes: the fold runs in the same ascending order,
    but not through the same additions, so a tolerance and no bit gate."""
    js, ts, E, x = _case(args, T=37)
    p = tops.pack_epitome(torch.from_numpy(E), ts, tq.QuantConfig(bits=4))
    cb = tops.kernel_col_blocks(ts)
    xt = torch.from_numpy(x)
    q = torch.nn.functional.pad(p.q, (0, 0, 0, (-ts.m) % p.bk))
    fused = tref.quant_epitome_matmul_fused_fold_ref(
        xt, q, p.scales, p.zeros, cb, ts.row_offsets(), bm=ts.bm, bk=p.bk, bn=p.bn)
    folded = torch.nn.functional.pad(tops.fold_rows(xt, ts), (0, q.shape[0] - ts.m))
    blocks = tref.quant_epitome_matmul_blocks_ref(folded, q, p.scales, p.zeros,
                                                  cb, p.bk, p.bn)
    np.testing.assert_allclose(fused.numpy(), blocks.numpy(), **BLOCK)
    np.testing.assert_allclose(tref.fold_blocks_ref(xt, ts.row_offsets(), ts.bm, ts.m).numpy(),
                               tops.fold_rows(xt, ts).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("args", [SPECS[1], SPECS[3], SPECS[5]])
def test_vs_pallas_kernels_interpret(args, pallas_compat):
    """The same inputs through the reference's Pallas kernels (interpret
    mode) and the port's wrappers."""
    js, ts, E, x = _case(args, T=20)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(
        tops.epitome_matmul(xt, torch.from_numpy(E), ts).numpy(),
        np.asarray(jops.epitome_matmul(xj, jnp.asarray(E), js, interpret=True)), **FP32)
    jp = jops.pack_epitome(jnp.asarray(E), js, jq.QuantConfig(bits=3))
    tp = tops.pack_epitome(torch.from_numpy(E), ts, tq.QuantConfig(bits=3))
    for fused in (False, True):
        np.testing.assert_allclose(
            tops.quant_epitome_matmul(xt, None, ts, packed=tp, fused_fold=fused).numpy(),
            np.asarray(jops.quant_epitome_matmul(xj, None, js, packed=jp,
                                                 fused_fold=fused, interpret=True)),
            **BLOCK)


def test_cpu_runs_plain_versions_and_counts_no_launch():
    js, ts, E, x = _case(SPECS[1])
    before = launch_counts()
    tops.epitome_matmul(torch.from_numpy(x), torch.from_numpy(E), ts)
    tops.quant_epitome_matmul(torch.from_numpy(x), torch.from_numpy(E), ts,
                              tq.QuantConfig(bits=3), fused_fold=True)
    assert launch_counts() == before


def test_non_cpu_non_cuda_tensor_raises():
    """Only a CPU tensor takes the plain version; anything else must launch
    the kernel, and a device that is not CUDA cannot."""
    x = torch.empty(4, 8, device="meta")
    cb = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        epitome_matmul_blocks(x, torch.empty(8, 8, device="meta"), cb, bn=8)
    q = torch.empty(8, 8, dtype=torch.int8, device="meta")
    s = torch.empty(1, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        quant_epitome_matmul_blocks(x, q, s, s, cb, bk=8, bn=8)
    with pytest.raises(ValueError, match="CUDA"):
        quant_epitome_matmul_fused_fold(x, q, s, s, cb, cb, bm=8, bk=8, bn=8)


# rows-only folding at CR 4 (the LM's projections, cut in width) and a wrap
BF16_SPECS = [(1024, 512, 256, 512, 256, 256), SPECS[1]]
BF16 = dict(rtol=2e-2, atol=2e-2)       # tests/test_kernels.py:17-18


@pytest.mark.parametrize("args", BF16_SPECS)
def test_bf16_quant_epitome_matmul_vs_pallas_interpret(args, pallas_compat):
    """A bfloat16 activation through the port's plain path and the
    reference's Pallas kernel in interpret mode: both return bfloat16."""
    js, ts, E, x = _case(args, T=12)
    jp = jops.pack_epitome(jnp.asarray(E), js, jq.QuantConfig(bits=3))
    tp = tops.pack_epitome(torch.from_numpy(E), ts, tq.QuantConfig(bits=3))
    y = tops.quant_epitome_matmul(torch.from_numpy(x).bfloat16(), None, ts, packed=tp)
    ref = jops.quant_epitome_matmul(jnp.asarray(x, jnp.bfloat16), None, js, packed=jp,
                                    interpret=True)
    assert y.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref, np.float32), **BF16)


@pytest.mark.parametrize("args", BF16_SPECS + [SPECS[3]])
def test_bf16_epitome_matmul_vs_pallas_interpret(args, pallas_compat):
    """A bfloat16 activation through the port's ``epitome_matmul`` (E cast to
    bf16, kernel #3's plain version) and the reference's Pallas kernel in
    interpret mode: both return bfloat16, within the bf16 tolerance."""
    js, ts, E, x = _case(args, T=12)
    y = tops.epitome_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(E), ts)
    ref = jops.epitome_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(E), js,
                              interpret=True)
    assert y.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert y.shape == (12, js.N)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref, np.float32), **BF16)


def test_bf16_fold_sums_in_float32_and_rounds_once():
    js, ts, _, x = _case(BF16_SPECS[0], T=9)
    xb = torch.from_numpy(x).bfloat16()
    folded = tops.fold_rows(xb, ts)
    assert folded.dtype == torch.bfloat16
    assert torch.equal(folded, tops.fold_rows(xb.float(), ts).bfloat16())
    ref = jops.fold_rows(jnp.asarray(x, jnp.bfloat16), js)       # bf16 segment_sum
    np.testing.assert_allclose(folded.float().numpy(), np.asarray(ref, np.float32), **BF16)


def test_bf16_plain_blocks_round_a_float32_product_once():
    js, ts, E, x = _case(SPECS[0], T=6)
    p = tops.pack_epitome(torch.from_numpy(E), ts, tq.QuantConfig(bits=3))
    cb = tops.kernel_col_blocks(ts)
    folded = tops.fold_rows(torch.from_numpy(x), ts).bfloat16()
    y = quant_epitome_matmul_blocks(folded, p.q, p.scales, p.zeros, cb, bk=p.bk, bn=p.bn)
    f32 = quant_epitome_matmul_blocks(folded.float(), p.q, p.scales, p.zeros, cb,
                                      bk=p.bk, bn=p.bn)
    assert y.dtype == torch.bfloat16 and torch.equal(y, f32.bfloat16())


@pytest.mark.parametrize("args", SPECS)
def test_fold_table_gathers_every_virtual_row_once(args):
    """The gather-and-sum fold against a scatter-add of the same rows: each
    virtual row lands in exactly one epitome row, in ascending order."""
    js, ts, _, x = _case(args, T=7)
    table = tops.fold_table(ts)
    real = table[table < ts.M]
    assert sorted(real.tolist()) == list(range(ts.M))
    assert all((np.diff(r[r < ts.M]) > 0).all() for r in table)
    assert (ts.row_index_map()[table[:, 0][table[:, 0] < ts.M]] ==
            np.arange(ts.m)[table[:, 0] < ts.M]).all()
    xt = torch.from_numpy(x).double()
    scatter = xt.new_zeros(7, ts.m).index_add_(-1, torch.as_tensor(ts.row_index_map()), xt)
    np.testing.assert_allclose(tops.fold_rows(torch.from_numpy(x), ts).numpy(),
                               scatter.numpy(), rtol=1e-6, atol=1e-6)


def test_build_reads_back_the_nvcc_log_of_a_built_library(tmp_path, monkeypatch):
    """A library found built is loaded as it is, and its nvcc log (ptxas'
    registers and spills) comes back from beside it: the card's checks of
    spills hold in a process that compiles nothing.  No nvcc is needed."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build_log", {})
    for name in _build.LIBRARIES:
        so = _build._target(name)
        so.write_bytes(b"")
        so.with_suffix(".log").write_text(f"ptxas info    : {name}\n")
    paths = _build.build_all()
    assert paths == {name: _build._target(name) for name in _build.LIBRARIES}
    assert _build.build_log == {name: f"ptxas info    : {name}\n" for name in _build.LIBRARIES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_kernel_1_rows_do_not_depend_on_the_row_count(dtype):
    """At rwkv6-7b's (4096, 4096) -> (2048, 4096) spec, rows 0..T-1 of a
    64-row call of the plain kernel #1 equal a T-row call bit for bit, and
    so do a rank's T rows from anywhere in the 64 (a data-parallel row
    split): the plain version sums every row in one fixed order
    (``ref.ROW_BLOCK``), where one float32 matmul of T rows picked another
    order for each T (up to 1.7e-6 apart in float32, one bf16 ulp)."""
    spec = tep.EpitomeSpec(4096, 4096, 2048, 4096, 256, 256)
    rng = np.random.default_rng(0)
    E = torch.from_numpy((rng.standard_normal((spec.m, spec.n)) / np.sqrt(spec.M))
                         .astype(np.float32))
    p = tops.pack_epitome(E, spec, tq.QuantConfig(bits=3))
    cb = torch.as_tensor(tops.kernel_col_blocks(spec, p.bn))
    x = torch.from_numpy(rng.standard_normal((64, spec.m)).astype(np.float32)).to(dtype)
    run = lambda rows: tref.quant_epitome_matmul_blocks_ref(rows, p.q, p.scales, p.zeros, cb,
                                                            p.bk, p.bn)
    whole = run(x)
    assert whole.dtype == dtype and whole.shape == (64, spec.n)
    for T in (1, 4, 16, 32, 64):
        assert torch.equal(run(x[:T]), whole[:T]), T
        lo = 64 - T - (7 if T < 57 else 0)
        assert torch.equal(run(x[lo:lo + T]), whole[lo:lo + T]), (T, lo)
