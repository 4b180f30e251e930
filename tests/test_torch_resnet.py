"""Port parity for the slice as a whole: tiny-resnet built by both packages'
``get_resnet``, initialized by the reference, carried across with
``convert.params_from_jax``, prepacked by both, applied to the same images.

Logits agree within 1e-4 * max(1, max|ref|).  The reference's epitome
layers run its Pallas kernels in interpret mode under the
``pallas_compat`` alias (jax 0.9 renamed ``pltpu.TPUCompilerParams``),
which is set for one test at a time and followed by ``jax.clear_caches``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_resnet as jax_get_resnet
from repro.models.resnet import ResNetModel as JaxResNet
from repro_torch.configs import get_resnet
from repro_torch.convert import params_from_jax
from repro_torch.kernels import launch_counts
from repro_torch.models.resnet import module_key

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


@pytest.fixture
def pallas_compat(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    yield
    jax.clear_caches()


IMAGES = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)


def _layer(tree, name):
    return tree[name] if name == "fc" else tree[name]["conv"]


def _check_model(variant, fused_fold=False):
    jm = jax_get_resnet("tiny-resnet", variant)
    tuned = {l.name: (None, True) for l in jm.layers} if fused_fold else None
    if tuned:
        jm = JaxResNet(jm.layers, jm.specs, quant_bits=jm.quant_bits, mode=jm.mode,
                       tuned=tuned)
    tm = get_resnet("tiny-resnet", variant, device="cpu", tuned=tuned)
    jp = jm.init(jax.random.PRNGKey(0))
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    jp = jm.prepack(jp)
    tm.prepack()
    tp = tm.params()
    packed = 0
    for l in jm.layers:
        a, b = _layer(jp, l.name), _layer(tp, l.name)
        assert set(a) == set(b), l.name
        if "Eq" in a:
            packed += 1
            np.testing.assert_array_equal(b["Eq"].numpy(), np.asarray(a["Eq"]))
            # the reference packs in a jitted program, where XLA multiplies
            # by the reciprocal of the level count instead of dividing: the
            # scales may differ by one float32 ulp
            for k in ("Es", "Ez"):
                np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), rtol=1e-6, atol=0)
    assert packed == (len(jm.layers) if variant == "kernel-q3" else 0)
    ref = np.asarray(jm.apply(jp, IMAGES))
    before = launch_counts()
    with torch.no_grad():
        y = tm.apply(torch.from_numpy(IMAGES)).numpy()
    assert launch_counts() == before           # CPU tensors: plain versions
    assert y.shape == ref.shape == (2, 10)
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_tiny_resnet_kernel_q3_matches_reference(pallas_compat):
    _check_model("kernel-q3")


def test_tiny_resnet_kernel_matches_reference(pallas_compat):
    _check_model("kernel")


def test_tiny_resnet_fused_fold_matches_reference(pallas_compat):
    _check_model("kernel-q3", fused_fold=True)


def test_tiny_resnet_dense_matches_reference():
    _check_model("off")


def test_model_structure_and_params_round_trip():
    m = get_resnet("tiny-resnet", "kernel-q3", device="cpu").init(torch.Generator().manual_seed(1))
    assert set(m.net.keys()) == {module_key(l.name) for l in m.layers}
    assert "layer1_0_conv2" in m.net and "." not in "".join(m.net.keys())
    tree = m.params()
    assert list(tree) == [l.name for l in m.layers]
    assert set(tree["layer1.0.conv2"]) == {"conv", "bn_g", "bn_b"}
    m.prepack()
    leaf = m.params()["layer1.0.conv2"]["conv"]
    assert leaf["Eq"].dtype == torch.int8
    assert "net.layer1_0_conv2.conv.Eq" in dict(m.named_buffers())
    assert "net.layer1_0_conv2.conv.E" in dict(m.named_parameters())
    twin = get_resnet("tiny-resnet", "kernel-q3", device="cpu").load_params(m.params())
    x = torch.from_numpy(IMAGES)
    with torch.no_grad():
        assert torch.equal(twin.apply(x), m.apply(x))
        assert torch.equal(m(x), m.apply(x))


def test_fused_quant_model_refuses_training():
    m = get_resnet("tiny-resnet", "kernel-q3", device="cpu").init()
    with pytest.raises(NotImplementedError, match="inference-only"):
        m.apply(torch.from_numpy(IMAGES)).sum().backward()


def test_plan_driven_variants_wait_for_slice_2():
    """The plan-driven variants, which waited for the plan slice, now build:
    an evo-* name runs the search and legalizer, and plan= takes the plan
    itself (parity with the reference is in test_torch_plan.py)."""
    from repro_torch.configs.registry import _evo_variant
    m = get_resnet("tiny-resnet", "evo-latency-q3", device="cpu")
    plan = _evo_variant("tiny-resnet", "evo-latency-q3")
    assert m.specs == plan.specs() and m.mode == "kernel" and set(m.layer_bits) == {3}
    assert get_resnet("tiny-resnet", "kernel-q3", plan=plan, device="cpu").specs == m.specs
    with pytest.raises(KeyError, match="unknown evo variant"):
        get_resnet("tiny-resnet", "evo-speed", device="cpu")
