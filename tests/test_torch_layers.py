"""Port parity: im2col, apply_conv and apply_linear of repro_torch.core.layers
against the JAX reference in every execution mode, including the 'SAME'
paddings that put the extra element at the end (stride 2 on even inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as jl
from repro.core.epitome import EpitomeSpec as JSpec
from repro.core.quant import QuantConfig as JQ
from repro_torch.core import layers as tl
from repro_torch.core.epitome import EpitomeSpec as TSpec
from repro_torch.core.quant import QuantConfig as TQ

TOL = dict(rtol=2e-4, atol=2e-4)

KH, KW, CIN, COUT = 3, 3, 16, 32
SPEC = (KH * KW * CIN, COUT, 96, 32, 16, 16)         # identity cols, 144 rows
SPEC_WRAPPED = (KH * KW * CIN, COUT, 96, 16, 16, 16)   # every col block wraps
MODES = [("reconstruct", None), ("wrapped", None), ("folded", None),
         ("wrapped", 3), ("folded", 3), ("kernel", None), ("kernel", 3),
         ("kernel", 4)]


@pytest.fixture
def pallas_compat(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    yield
    jax.clear_caches()


def _cfgs(spec, mode, bits, fused_fold=False):
    j = jl.EpLayerConfig(spec=JSpec(*spec) if spec else None, mode=mode,
                         quant=JQ(bits=bits) if bits else None, fused_fold=fused_fold)
    t = tl.EpLayerConfig(spec=TSpec(*spec) if spec else None, mode=mode,
                         quant=TQ(bits=bits) if bits else None, fused_fold=fused_fold)
    return j, t


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (57, 3, 2, (1, 1)), (56, 1, 2, (0, 0)), (14, 3, 1, (1, 1)), (7, 1, 1, (0, 0)),
])
def test_same_pads_are_xla_same(size, k, stride, pads):
    assert tl.same_pads(size, k, stride) == pads


@pytest.mark.parametrize("hw", [(9, 9), (10, 10), (11, 8)])
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID"), (2, "VALID")])
def test_im2col_matches(hw, k, stride, padding):
    x = _images((2, *hw, 5))
    a = tl.im2col(torch.from_numpy(x), k, k, stride=stride, padding=padding)
    b = jl.im2col(jnp.asarray(x), k, k, stride=stride, padding=padding)
    assert tuple(a.shape) == b.shape
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


CONV_CASES = [((10, 10), 2, "SAME"), ((9, 9), 2, "SAME"), ((9, 9), 1, "VALID"),
              ((8, 8), 1, "SAME")]


def _check_conv(mode, bits, fused_fold=False):
    for spec in (SPEC, SPEC_WRAPPED):
        jcfg, tcfg = _cfgs(spec, mode, bits, fused_fold)
        E = _images((spec[2], spec[3]), seed=1) / 12.0
        for hw, stride, padding in CONV_CASES:
            x = _images((2, *hw, CIN))
            y = tl.apply_conv({"E": torch.from_numpy(E)}, torch.from_numpy(x), KH, KW,
                              CIN, COUT, tcfg, stride=stride, padding=padding)
            ref = jl.apply_conv({"E": jnp.asarray(E)}, jnp.asarray(x), KH, KW, CIN,
                                COUT, jcfg, stride=stride, padding=padding)
            assert tuple(y.shape) == ref.shape
            np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode,bits", [m for m in MODES if m[0] != "kernel"])
def test_apply_conv_every_mode(mode, bits):
    _check_conv(mode, bits)


def test_apply_conv_kernel_modes(pallas_compat):
    """The kernel modes against the reference's Pallas kernels, run in
    interpret mode: fp, fused int8 at 3 and 4 bits, and the fused fold."""
    for mode, bits in MODES:
        if mode == "kernel":
            _check_conv(mode, bits)
    _check_conv("kernel", 3, fused_fold=True)


@pytest.mark.parametrize("k,stride,hw", [(7, 2, (16, 16)), (3, 2, (10, 10)),
                                         (1, 2, (10, 10)), (3, 1, (9, 9))])
def test_dense_conv_asymmetric_same(k, stride, hw):
    jcfg, tcfg = _cfgs(None, "reconstruct", None)
    W = _images((k, k, 4, 6), seed=2)
    x = _images((2, *hw, 4))
    y = tl.apply_conv({"W": torch.from_numpy(W)}, torch.from_numpy(x), k, k, 4, 6, tcfg,
                      stride=stride)
    ref = jl.apply_conv({"W": jnp.asarray(W)}, jnp.asarray(x), k, k, 4, 6, jcfg,
                        stride=stride)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)


def _check_linear(mode, bits, fused_fold=False):
    spec = (512, 768, 256, 256, 128, 256)
    jcfg, tcfg = _cfgs(spec, mode, bits, fused_fold=fused_fold)
    E = _images(spec[2:4], seed=3) / 20.0
    x = _images((3, 4, spec[0]))
    b = _images((spec[1],), seed=4)
    y = tl.apply_linear({"E": torch.from_numpy(E), "b": torch.from_numpy(b)},
                        torch.from_numpy(x), tcfg)
    ref = jl.apply_linear({"E": jnp.asarray(E), "b": jnp.asarray(b)}, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode,bits", [m for m in MODES if m[0] != "kernel"])
def test_apply_linear_every_mode(mode, bits):
    _check_linear(mode, bits)


def test_apply_linear_kernel_modes(pallas_compat):
    for mode, bits in MODES:
        if mode == "kernel":
            _check_linear(mode, bits)
    _check_linear("kernel", 3, fused_fold=True)


def test_dense_linear_and_effective_weight():
    for bits in (None, 4):
        jcfg, tcfg = _cfgs(None, "reconstruct", bits)
        W = _images((64, 48), seed=5)
        x = _images((5, 64))
        np.testing.assert_allclose(
            tl.apply_linear({"W": torch.from_numpy(W)}, torch.from_numpy(x), tcfg).numpy(),
            np.asarray(jl.apply_linear({"W": jnp.asarray(W)}, jnp.asarray(x), jcfg)), **TOL)
    jcfg, tcfg = _cfgs(SPEC, "kernel", 3)
    E = _images(SPEC[2:4], seed=6)
    np.testing.assert_allclose(
        tl.effective_weight({"E": torch.from_numpy(E)}, tcfg).numpy(),
        np.asarray(jl.effective_weight({"E": jnp.asarray(E)}, jcfg)), rtol=1e-6, atol=1e-6)


def test_prepack_linear_codes_and_same_output():
    jcfg, tcfg = _cfgs(SPEC, "kernel", 3)
    E = _images(SPEC[2:4], seed=7) / 12.0
    pt = tl.prepack_linear({"E": torch.from_numpy(E)}, tcfg)
    pj = jl.prepack_linear({"E": jnp.asarray(E)}, jcfg)
    assert pt["Eq"].dtype == torch.int8
    np.testing.assert_array_equal(pt["Eq"].numpy(), np.asarray(pj["Eq"]))
    # the reference packs in a jitted program, where XLA multiplies by the
    # reciprocal of the level count instead of dividing: one ulp at most
    np.testing.assert_allclose(pt["Es"].numpy(), np.asarray(pj["Es"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(pt["Ez"].numpy(), np.asarray(pj["Ez"]), rtol=1e-6, atol=0)
    x = torch.from_numpy(_images((7, SPEC[0])))
    assert torch.equal(tl.apply_linear(pt, x, tcfg),
                       tl.apply_linear({"E": torch.from_numpy(E)}, x, tcfg))
    assert tl.prepack_linear({"E": torch.from_numpy(E)}, _cfgs(SPEC, "kernel", None)[1]).keys() == {"E"}


def test_fused_quant_path_refuses_training():
    _, tcfg = _cfgs(SPEC, "kernel", 3)
    E = torch.from_numpy(_images(SPEC[2:4], seed=8)).requires_grad_(True)
    y = tl.apply_linear({"E": E}, torch.from_numpy(_images((4, SPEC[0]))), tcfg)
    with pytest.raises(NotImplementedError, match="inference-only"):
        y.sum().backward()


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, 2e-4), (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_exact_dot_and_dense_linear_in_compute_dtype(dtype, jdtype, tol):
    """The dense branch rounds both operands to a narrow compute dtype and
    multiplies in float32, as the reference's exact_dot does."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    W = (rng.standard_normal((48, 24)) / 7).astype(np.float32)
    a = tl.exact_dot(torch.from_numpy(x).to(dtype), torch.from_numpy(W))
    b = jl.exact_dot(jnp.asarray(x, jdtype), jnp.asarray(W))
    assert a.dtype == dtype
    np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        xb, Wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(W).bfloat16()
        assert torch.equal(a, (xb.float() @ Wb.float()).bfloat16())
    jcfg, tcfg = _cfgs(None, "wrapped", None)
    y = tl.apply_linear({"W": torch.from_numpy(W)}, torch.from_numpy(x).to(dtype), tcfg)
    ref = jl.apply_linear({"W": jnp.asarray(W)}, jnp.asarray(x, jdtype), jcfg)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_prepack_tree_packs_named_kernel_quant_sites_only():
    jcfg, tcfg = _cfgs(SPEC, "kernel", 3)
    _, fold_cfg = _cfgs(SPEC, "folded", 3)
    E = torch.from_numpy(_images((SPEC[2], SPEC[3]), seed=2) / 12.0)
    tree = {"L0": {"mixer": {"wr": {"E": E}, "wk": {"E": E}, "mu": torch.ones(3)},
                   "norm1": torch.zeros(3)}}
    out = tl.prepack_tree(tree, {"L0/mixer/wr": tcfg, "L0/mixer/wk": fold_cfg})
    assert set(out["L0"]["mixer"]["wr"]) == {"E", "Eq", "Es", "Ez"}
    assert out["L0"]["mixer"]["wk"] is tree["L0"]["mixer"]["wk"]
    assert out["L0"]["norm1"] is tree["L0"]["norm1"]
    ref = jl.prepack_linear({"E": jnp.asarray(E.numpy())}, jcfg)
    np.testing.assert_array_equal(out["L0"]["mixer"]["wr"]["Eq"].numpy(), np.asarray(ref["Eq"]))


# -- training: the folded path's gradient, and the kernel modes' refusal ------
# (M, N, m, n, bm, bn): aligned, every column block wrapped, spread
# (overlapping) offsets with ragged edges on both axes
GRAD_SPECS = [(512, 768, 256, 256, 128, 256), SPEC_WRAPPED, (100, 90, 37, 29, 16, 16)]


@pytest.mark.parametrize("spec", GRAD_SPECS)
@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, 2e-4), (torch.bfloat16, jnp.bfloat16, 5e-2)])
def test_folded_matmul_grads_match_reference(spec, dtype, jdtype, tol):
    """y, dx and dE of folded_matmul against jax.grad of the reference's
    folded_matmul (segment_sum fold, take gather).  float32 at this file's
    tolerance; bfloat16 at the LM tests' BF16_TOL of each result's scale:
    the port sums the fold and dy's column preimages in float32 and rounds
    once, the reference adds in bf16 (the deviation ROADMAP section 3
    records for ops.fold_rows)."""
    from repro.core.epitome import folded_matmul as jfolded
    from repro_torch.core.epitome import folded_matmul
    js, ts = JSpec(*spec), TSpec(*spec)
    x = _images((2, 3, spec[0]), seed=11)
    E = _images(spec[2:4], seed=12) / 10.0
    dy = _images((2, 3, spec[1]), seed=13)
    f = lambda x_, E_: jnp.sum(jfolded(x_, E_, js).astype(jnp.float32) * dy)
    jy = jfolded(jnp.asarray(x, jdtype), jnp.asarray(E), js)
    jdx, jdE = jax.grad(f, argnums=(0, 1))(jnp.asarray(x, jdtype), jnp.asarray(E))
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    Et = torch.from_numpy(E).requires_grad_(True)
    y = folded_matmul(xt, Et, ts)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    assert y.dtype == dtype and xt.grad.dtype == dtype and Et.grad.dtype == torch.float32
    for a, r in ((y, jy), (xt.grad, jdx), (Et.grad, jdE)):
        r = np.asarray(r, np.float32)
        err, scale = float(np.abs(a.detach().float().numpy() - r).max()), float(np.abs(r).max())
        assert err <= tol * max(1.0, scale), f"{err:.3e} > {tol} * {scale:.3e}"


def test_folded_matmul_gathers_and_never_scatters():
    """Forward and backward of folded_matmul run gathers, sums and products
    only: no index_add_, scatter or accumulating index_put, which add with
    atomics in a changing order on the card (ops.fold_rows' finding)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.epitome import folded_matmul
    spec = TSpec(*SPEC_WRAPPED)
    x = torch.from_numpy(_images((4, spec.M), seed=14)).requires_grad_(True)
    E = torch.from_numpy(_images((spec.m, spec.n), seed=15)).requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        folded_matmul(x, E, spec).square().sum().backward()
    ops = {e.key for e in prof.key_averages()}
    assert "aten::index_select" in ops
    assert not [o for o in ops if "index_add" in o or "scatter" in o or "index_put" in o], ops
    assert x.grad is not None and E.grad is not None


@pytest.mark.parametrize("bits", [None, 3])
def test_kernel_modes_refuse_training_and_serve_without_grad(bits):
    """mode='kernel', quantized or not, raises NotImplementedError on
    backward (the reference's pallas_call has no gradient); without grad
    the kernel path runs as it always did."""
    _, tcfg = _cfgs(SPEC, "kernel", bits)
    E = torch.from_numpy(_images(SPEC[2:4], seed=8)).requires_grad_(True)
    x = torch.from_numpy(_images((4, SPEC[0])))
    y = tl.apply_linear({"E": E}, x, tcfg)
    with pytest.raises(NotImplementedError, match="inference-only"):
        y.sum().backward()
    with torch.no_grad():
        y0 = tl.apply_linear({"E": E}, x, tcfg)
    assert y0.grad_fn is None and torch.equal(y0, y.detach())
