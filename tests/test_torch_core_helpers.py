"""Port parity: the last helpers of the reference that the port lacked,
against the JAX reference on the CPU: ``core.epitome.epitomize_dense`` (the
coverage-normalized scatter-add adjoint of ``reconstruct``),
``core.quant.quant_mse`` and ``dequantize_epitome``, the WKV's naive
recurrence ``kernels.ref.wkv6_ref``, and ``launch.serve``'s deprecated
``--batch`` / ``--gen`` aliases."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import epitome as jep
from repro.core import quant as jq
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro_torch import core as tcore
from repro_torch.core import epitome as tep
from repro_torch.core import quant as tq
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

# (M, N, m, n, bm, bn): aligned, wrapped with spread offsets, ragged and prime
SPECS = [(512, 512, 256, 256, 128, 256), (1024, 1024, 512, 512, 128, 256),
         (100, 90, 37, 29, 16, 16)]


def _dense(args, seed=0):
    M, N = args[:2]
    return np.random.default_rng(seed).standard_normal((M, N)).astype(np.float32)


@pytest.mark.parametrize("args", SPECS)
def test_epitomize_dense_matches_reference(args):
    W = _dense(args)
    want = np.asarray(jep.epitomize_dense(jnp.asarray(W), jep.EpitomeSpec(*args)))
    got = tcore.epitomize_dense(torch.from_numpy(W), tep.EpitomeSpec(*args))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("args", SPECS)
def test_epitomize_dense_round_trips_through_reconstruct(args):
    """A W that is some E's reconstruction gives E back on every covered
    cell (each is the mean of copies of itself) and 0 on the rest."""
    spec = tep.EpitomeSpec(*args)
    E = torch.from_numpy(np.random.default_rng(1).standard_normal((spec.m, spec.n))
                         .astype(np.float32))
    covered = torch.from_numpy(tep.overlap_counts(spec) > 0)
    back = tep.epitomize_dense(tep.reconstruct(E, spec), spec)
    torch.testing.assert_close(back, torch.where(covered, E, torch.zeros_like(E)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", [2, 3, 8])
@pytest.mark.parametrize("args", SPECS[:2])
def test_quant_mse_matches_reference(args, bits):
    m, n = args[2:4]
    E = np.random.default_rng(bits).standard_normal((m, n)).astype(np.float32) * 0.05
    want = float(jq.quant_mse(jnp.asarray(E), jep.EpitomeSpec(*args), jq.QuantConfig(bits=bits)))
    got = tcore.quant_mse(torch.from_numpy(E), tep.EpitomeSpec(*args), tq.QuantConfig(bits=bits))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def test_dequantize_epitome_bit_for_bit():
    args = SPECS[1]
    E = np.random.default_rng(7).standard_normal(args[2:4]).astype(np.float32) * 0.05
    q, S, Z = jq.quantize_epitome(jnp.asarray(E), jep.EpitomeSpec(*args), jq.QuantConfig(bits=3))
    want = np.asarray(jq.dequantize_epitome(q, S, Z))
    got = tcore.dequantize_epitome(*(torch.from_numpy(np.array(t)) for t in (q, S, Z)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_naive_recurrence_matches_reference(dtype):
    rng = np.random.default_rng(3)
    BH, S, K = 6, 23, 16
    r, k, v = (rng.standard_normal((BH, S, K)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.standard_normal((BH, S, K)).astype(np.float32) * 0.5)
    u = rng.standard_normal((BH, K)).astype(np.float32) * 0.1
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jref.wkv6_ref(*(jnp.asarray(a, jd) for a in (r, k, v)), jnp.asarray(logw),
                         jnp.asarray(u))
    got = tref.wkv6_ref(*(torch.from_numpy(a).to(td) for a in (r, k, v)),
                        torch.from_numpy(logw), torch.from_numpy(u))
    assert got.dtype == td and tuple(got.shape) == (BH, S, K)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("argv,want", [
    ([], (4, 16)),
    (["--batch", "3", "--gen", "5"], (3, 5)),
    (["--batch", "3", "--requests", "7", "--gen", "5", "--max-new-tokens", "9"], (7, 9)),
    (["--requests", "2", "--max-new-tokens", "6"], (2, 6))])
def test_serve_deprecated_aliases(argv, want):
    """--batch and --gen warn (DeprecationWarning) and fill --requests and
    --max-new-tokens; the new flag wins when both are given; the defaults
    stay 4 requests and 16 tokens.  The reference's resolution of the same
    flags gives the same numbers and the same warnings."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        args = serve.parse_args(argv)
    assert (args.requests, args.max_new_tokens) == want
    ref = jserve.build_parser().parse_args(argv)
    with warnings.catch_warnings(record=True) as ref_seen:
        warnings.simplefilter("always")
        jserve._resolve_deprecated(ref, "batch", "requests")
        jserve._resolve_deprecated(ref, "gen", "max_new_tokens")
    ref_want = (4 if ref.requests is None else ref.requests,
                16 if ref.max_new_tokens is None else ref.max_new_tokens)
    assert ref_want == want
    messages = [str(w.message) for w in seen if w.category is DeprecationWarning]
    assert messages == [str(w.message) for w in ref_seen]
    assert len(messages) == ("--batch" in argv) + ("--gen" in argv)
