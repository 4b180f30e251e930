"""Port parity: the epitome spec, its integer tables, the spec designers and
the float reconstruction paths of repro_torch.core.epitome against the JAX
reference repro.core.epitome."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import epitome as jep
from repro.pim import plan as jplan
from repro.pim import workloads as jwl
from repro_torch.core import epitome as tep
from repro_torch.pim import plan as tplan
from repro_torch.pim import workloads as twl

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

# (M, N, m, n, bm, bn): aligned, wrapped, ragged virtual edges, ragged and
# prime m, spread (overlapping) offsets on both axes
SPECS = [
    (512, 512, 256, 256, 128, 256),
    (512, 768, 256, 256, 128, 256),
    (1024, 1024, 512, 512, 128, 256),
    (640, 512, 256, 256, 128, 256),
    (1152, 128, 288, 128, 256, 128),
    (2048, 1000, 2000, 256, 256, 256),
    (512, 512, 251, 256, 128, 256),
    (144, 32, 96, 16, 16, 16),
    (27, 16, 27, 8, 8, 8),
    (100, 90, 37, 29, 16, 16),
]


def _pair(args):
    return jep.EpitomeSpec(*args), tep.EpitomeSpec(*args)


@pytest.mark.parametrize("args", SPECS)
def test_index_maps_and_overlaps_equal(args):
    js, ts = _pair(args)
    assert (js.gm, js.gn, js.compression_rate) == (ts.gm, ts.gn, ts.compression_rate)
    for fn in ("row_offsets", "col_offsets", "row_index_map", "col_index_map"):
        np.testing.assert_array_equal(getattr(js, fn)(), getattr(ts, fn)())
    for a, b in zip(js.unique_col_blocks(), ts.unique_col_blocks()):
        np.testing.assert_array_equal(a, b)
    assert js.wrap_factor == ts.wrap_factor
    np.testing.assert_array_equal(jep.overlap_counts(js), tep.overlap_counts(ts))
    np.testing.assert_array_equal(jep.overlap_mask(js), tep.overlap_mask(ts))


def test_overlap_counts_over_property_ranges():
    """The grid of tests/test_epitome.py's overlap property, exhaustively."""
    for m, n, gm, gn in itertools.product(range(2, 9), range(2, 9), range(1, 7), range(1, 7)):
        args = (16 * gm, 16 * gn, min(16 * m, 16 * gm), min(16 * n, 16 * gn), 16, 16)
        js, ts = _pair(args)
        np.testing.assert_array_equal(jep.overlap_counts(js), tep.overlap_counts(ts))


def test_plan_epitome_equal():
    for M, N in itertools.product(range(64, 1281, 96), range(64, 1281, 160)):
        for cr in (1.5, 2.0, 4.0, 7.3, 16.0):
            a = jep.plan_epitome(M, N, cr, patch=(64, 64), align=32)
            b = tep.plan_epitome(M, N, cr, patch=(64, 64), align=32)
            assert (a is None and b is None) or dataclass_tuple(a) == dataclass_tuple(b)
    assert tep.plan_epitome(16, 16, 1.0) is None


def dataclass_tuple(s):
    return (s.M, s.N, s.m, s.n, s.bm, s.bn)


@pytest.mark.parametrize("arch,cr,patch", [
    ("tiny_resnet_layers", 2.0, (8, 8)),
    ("resnet50_layers", 4.0, (256, 256)),
    ("resnet101_layers", 4.0, (256, 256)),
])
def test_plan_conv_specs_equal(arch, cr, patch):
    """The inventories and the kernel-exact designer at the registry's CR
    and patch: the same layers, specs and dense layers as the reference."""
    jl, tl = getattr(jwl, arch)(), getattr(twl, arch)()
    assert [dataclasses_astuple(l) for l in jl] == [dataclasses_astuple(l) for l in tl]
    js = jplan.plan_conv_specs(jl, target_cr=cr, patch=patch)
    ts = tplan.plan_conv_specs(tl, target_cr=cr, patch=patch)
    assert [s and dataclass_tuple(s) for s in js] == [s and dataclass_tuple(s) for s in ts]
    assert [jplan.is_kernel_exact(s) for s in js if s] == \
        [tplan.is_kernel_exact(s) for s in ts if s]


def dataclasses_astuple(l):
    return (l.name, l.kh, l.kw, l.cin, l.cout, l.out_hw, l.stride, l.kind,
            l.rows, l.cols, l.rounds)


def test_resnet50_main_path_shapes():
    """ResNet-50 at CR 4, patch 256: 45 epitomized layers (44 convs + fc)
    in 16 distinct kernel shapes, the nine dense layers as listed in the
    port's main path."""
    layers = twl.resnet50_layers()
    specs = tplan.plan_conv_specs(layers, target_cr=4.0, patch=(256, 256))
    dense = [l.name for l, s in zip(layers, specs) if s is None]
    assert dense == ["conv1", "layer1.0.conv1", "layer1.0.conv3", "layer1.0.down",
                     "layer1.1.conv1", "layer1.1.conv3", "layer1.2.conv1",
                     "layer1.2.conv3", "layer2.0.conv1"]
    shapes = {(s.M, s.N, s.m, s.n, s.bm, s.bn) for s in specs if s}
    assert sum(s is not None for s in specs) == 45 and len(shapes) == 16
    assert (2048, 1000, 2000, 256, 256, 256) in shapes


@pytest.mark.parametrize("args", SPECS[:8])
def test_float_paths_match(args):
    js, ts = _pair(args)
    rng = np.random.default_rng(0)
    E = rng.standard_normal((js.m, js.n)).astype(np.float32)
    x = rng.standard_normal((6, js.M)).astype(np.float32)
    Ej, xj, Et, xt = jnp.asarray(E), jnp.asarray(x), torch.from_numpy(E), torch.from_numpy(x)
    np.testing.assert_array_equal(np.asarray(jep.reconstruct(Ej, js)),
                                  tep.reconstruct(Et, ts).numpy())
    for fn in ("epitome_matmul_ref", "wrapped_matmul", "folded_matmul"):
        np.testing.assert_allclose(getattr(tep, fn)(xt, Et, ts).numpy(),
                                   np.asarray(getattr(jep, fn)(xj, Ej, js)),
                                   rtol=1e-5, atol=1e-5 * np.sqrt(js.M))


def test_init_epitome_seeded_and_fan_in_scaled():
    spec = tep.EpitomeSpec(1024, 256, 256, 256, 256, 256)
    a = tep.init_epitome(torch.Generator().manual_seed(3), spec, device="cpu")
    b = tep.init_epitome(torch.Generator().manual_seed(3), spec, device="cpu")
    assert a.shape == (256, 256) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert abs(float(a.std()) * 32 - 1.0) < 0.02        # 1/sqrt(M) = 1/32
