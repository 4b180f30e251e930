"""Port parity: the epitome-aware quantizer of repro_torch.core.quant against
the JAX reference.  The int8 codes must be equal; scales and zeros agree
within one float32 ulp (rtol=1e-6).  The reference's eager quantizer runs
the same float32 operations in the same order, so here they are in fact
equal bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import epitome as jep
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro_torch.core import epitome as tep
from repro_torch.core import quant as tq
from repro_torch.kernels import ops as tops

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

SPECS = {
    "aligned": (512, 512, 256, 512, 128, 256),
    "wrapped": (512, 768, 256, 256, 128, 256),
    "ragged_m288": (1152, 128, 288, 128, 256, 128),
    "ragged_m2000": (2048, 1000, 2000, 256, 256, 256),
    "prime_m251": (512, 512, 251, 256, 128, 256),
}


def _inputs(key, scale=1.0):
    args = SPECS[key]
    E = np.random.default_rng(len(key)).standard_normal(args[2:4]).astype(np.float32) * scale
    E[0, 0], E[-1, -1] = 6.0 * scale, -6.0 * scale        # edge outliers
    return jep.EpitomeSpec(*args), tep.EpitomeSpec(*args), E


@pytest.mark.parametrize("bits", [3, 4, 8])
@pytest.mark.parametrize("key", sorted(SPECS))
def test_packed_codes_equal(key, bits):
    js, ts, E = _inputs(key, scale=0.05)
    jcfg, tcfg = jq.QuantConfig(bits=bits), tq.QuantConfig(bits=bits)
    jbk, jbn = jops.pack_blocks(js, jcfg)
    assert (jbk, jbn) == tops.pack_blocks(ts, tcfg)
    qj, sj, zj = jq.quantize_epitome_packed(jnp.asarray(E), js, jcfg, (jbk, jbn))
    qt, st, zt = tq.quantize_epitome_packed(torch.from_numpy(E), ts, tcfg, (jbk, jbn))
    assert qt.dtype == torch.int8 and qt.shape == qj.shape
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.shape == sj.shape == (-(-ts.m // jbk), ts.n // jbn)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=0)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        tq.dequantize_packed(qt, st, zt, (jbk, jbn)).numpy(),
        np.asarray(jq.dequantize_packed(qj, sj, zj, (jbk, jbn))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cfg_kw", [
    dict(bits=3), dict(bits=8, symmetric=True),
    dict(bits=4, per_crossbar=False), dict(bits=3, overlap_weighted=False),
])
def test_fake_quant_and_ranges_match(cfg_kw):
    js, ts, E = _inputs("ragged_m288")
    jcfg, tcfg = jq.QuantConfig(**cfg_kw), tq.QuantConfig(**cfg_kw)
    for a, b in zip(jq.epitome_ranges(jnp.asarray(E), js, jcfg),
                    tq.epitome_ranges(torch.from_numpy(E), ts, tcfg)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(
        tq.fake_quant(torch.from_numpy(E), ts, tcfg).numpy(),
        np.asarray(jq.fake_quant(jnp.asarray(E), js, jcfg)), rtol=1e-6, atol=1e-7)


def test_tile_reduce_ragged_edge():
    x = np.random.default_rng(1).uniform(1.0, 2.0, (37, 29)).astype(np.float32)
    for fn_t, fn_j in ((torch.amin, jnp.min), (torch.amax, jnp.max)):
        np.testing.assert_array_equal(tq._tile_reduce(torch.from_numpy(x), 16, fn_t).numpy(),
                                      np.asarray(jq._tile_reduce(jnp.asarray(x), 16, fn_j)))
        np.testing.assert_array_equal(
            tq._block_reduce(torch.from_numpy(x), 8, 16, fn_t).numpy(),
            np.asarray(jq._block_reduce(jnp.asarray(x), 8, 16, fn_j)))


def test_round_half_to_even():
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(v))))


def test_fake_quant_straight_through_gradient():
    _, ts, E = _inputs("wrapped")
    Et = torch.from_numpy(E).requires_grad_(True)
    (tq.fake_quant(Et, ts, tq.QuantConfig(bits=3)) * 3.0).sum().backward()
    np.testing.assert_array_equal(Et.grad.numpy(), np.full(E.shape, 3.0, np.float32))
    # the reference's STE gives the same gradient
    g = jax.grad(lambda e: (jq.fake_quant(e, _inputs("wrapped")[0],
                                          jq.QuantConfig(bits=3)) * 3.0).sum())(jnp.asarray(E))
    np.testing.assert_array_equal(np.asarray(g), Et.grad.numpy())
