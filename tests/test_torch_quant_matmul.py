"""Port parity for kernel #5, the dense int8 matmul with one (scale, zero)
per 256 x 256 crossbar tile: the port's ``ops.quant_matmul`` (on the CPU,
the plain version ``ref.quant_matmul_ref``) against the reference's
``ops.quant_matmul`` in Pallas interpret mode, on the same seeded numpy
inputs, at the reference's shapes and tolerances
(``tests/test_kernels.py:16-18``, ``:97-132``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.epitome import EpitomeSpec as JSpec
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.quant import quantize_epitome as jquantize_epitome
from repro.kernels import ops as jops
from repro.kernels.ref import quant_matmul_ref as jquant_matmul_ref
from repro_torch.core.epitome import EpitomeSpec
from repro_torch.core.quant import QuantConfig, dequantize, quantize_epitome
from repro_torch.kernels import launch_counts, ops, ref

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

DTYPES = {"float32": (torch.float32, jnp.float32, dict(rtol=2e-4, atol=2e-4)),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, dict(rtol=2e-2, atol=2e-2))}


def _case(T, M, N, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (M, N)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-2, (M // 256, N // 256)).astype(np.float32)
    z = np.round(rng.uniform(-3, 3, (M // 256, N // 256))).astype(np.float32)
    x = rng.standard_normal((*lead, T, M)).astype(np.float32)
    return x, q, s, z


def _both(x, q, s, z, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    before = launch_counts()
    y = ops.quant_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(q),
                         torch.from_numpy(s), torch.from_numpy(z))
    assert launch_counts() == before            # CPU tensors: the plain version
    want = jops.quant_matmul(jnp.asarray(x, jdt), jnp.asarray(q), jnp.asarray(s),
                             jnp.asarray(z), interpret=True)
    assert y.dtype == tdt and tuple(y.shape) == want.shape
    return y.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("T,M,N", [(8, 256, 256), (32, 512, 768), (7, 512, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_reference_kernel(T, M, N, dtype):
    y, want = _both(*_case(T, M, N), dtype)
    np.testing.assert_allclose(y, want, **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leading_dims(dtype):
    """(2, 3, 5, M) rows flatten to T = 30, pad to the row block and trim
    back, as the reference's wrapper does."""
    x, q, s, z = _case(5, 512, 256, seed=1, lead=(2, 3))
    y, want = _both(x, q, s, z, dtype)
    assert y.shape == (2, 3, 5, 256)
    np.testing.assert_allclose(y, want, **DTYPES[dtype][2])


def test_plain_version_matches_reference_oracle():
    x, q, s, z = _case(16, 768, 512, seed=2)
    y = ref.quant_matmul_ref(*(torch.from_numpy(a) for a in (x, q, s, z)))
    want = jquant_matmul_ref(*(jnp.asarray(a) for a in (x, q, s, z)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_matches_epitome_aware_quantizer():
    """End to end, as ``test_kernels.py::test_matches_epitome_aware_
    quantizer``: quantize an epitome with per-crossbar scales by the port's
    quantizer, shift the unsigned 8-bit codes into int8 range with the
    shift folded into the per-tile zero, run the kernel, and compare with
    the dequantized dense matmul; the codes equal the reference's."""
    rng = np.random.default_rng(3)
    E = rng.standard_normal((512, 512)).astype(np.float32)
    x = rng.standard_normal((16, 512)).astype(np.float32)
    kw = dict(bits=8, per_crossbar=True, overlap_weighted=False, tile=256)
    spec = EpitomeSpec(M=512, N=512, m=512, n=512, bm=128, bn=256)
    qfull, S, Z = quantize_epitome(torch.from_numpy(E), spec, QuantConfig(**kw))
    jq, _, _ = jquantize_epitome(jnp.asarray(E), JSpec(M=512, N=512, m=512, n=512,
                                                       bm=128, bn=256), JQuantConfig(**kw))
    np.testing.assert_array_equal(qfull.numpy(), np.asarray(jq))
    s_t = S[::256, ::256].contiguous()
    z_t = (Z[::256, ::256] + 128.0).contiguous()
    q_i8 = (qfull - 128.0).to(torch.int8)
    xt = torch.from_numpy(x)
    y = ops.quant_matmul(xt, q_i8, s_t, z_t)
    np.testing.assert_allclose(y.numpy(), (xt @ dequantize(qfull, S, Z)).numpy(),
                               rtol=1e-3, atol=1e-3)
