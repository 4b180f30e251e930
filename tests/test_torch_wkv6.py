"""Port parity: the chunked RWKV6 WKV of repro_torch.kernels (its wrapper on
CPU tensors, i.e. the plain version the CUDA kernel is held against) against
the JAX reference: its Pallas kernel ``wkv6_chunked`` in interpret mode, its
naive oracle, and the LM's own chunked recurrence ``ssm.rwkv_chunked`` with
a carried state.  The reference's wkv6 tolerance is 1e-3
(tests/test_kernels.py:85)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import wkv6_ref as jwkv6_ref
from repro.models import ssm as jssm
from repro_torch.kernels import launch_counts, ops as tops, ref as tref
from repro_torch.kernels.wkv6 import wkv6_chunked

TOL = dict(rtol=1e-3, atol=1e-3)

# the reference's own cases (tests/test_kernels.py:67-72), ragged S=50 included
CASES = [(1, 16, 1, 8, 8), (2, 64, 2, 16, 16), (2, 50, 2, 8, 16), (1, 128, 4, 32, 64)]


def _inputs(B, S, H, K, seed=0, state=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = dict(r=f(B, S, H, K), k=f(B, S, H, K), v=f(B, S, H, K),
               lw=-np.exp(f(B, S, H, K) * 0.5), u=f(H, K) * 0.1)
    if state:
        out["s"] = f(B, H, K, K) * 0.5
    return out


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("B,S,H,K,chunk", CASES)
def test_zero_state_matches_pallas_kernel(B, S, H, K, chunk):
    d = _inputs(B, S, H, K)
    ref = jops.wkv6(*(jnp.asarray(d[n]) for n in ("r", "k", "v", "lw", "u")),
                    chunk=chunk, interpret=True)
    o, _ = tops.wkv6(*(_t(d[n]) for n in ("r", "k", "v", "lw", "u")), chunk=chunk)
    assert o.dtype == torch.float32 and tuple(o.shape) == (B, S, H, K)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,S,H,K,chunk", CASES)
def test_naive_plain_version_matches_reference_oracle(B, S, H, K, chunk):
    d = _inputs(B, S, H, K, seed=1)
    to_bh = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(B * H, S, K)
    ref = jwkv6_ref(*(to_bh(d[n]) for n in ("r", "k", "v", "lw")),
                    jnp.tile(jnp.asarray(d["u"]), (B, 1)))
    ref = np.asarray(ref).reshape(B, H, S, K).transpose(0, 2, 1, 3)
    o, _ = tref.wkv6_naive_ref(*(_t(d[n]) for n in ("r", "k", "v", "lw", "u")))
    np.testing.assert_allclose(o.numpy(), ref, **TOL)


@pytest.mark.parametrize("B,S,H,K,chunk", CASES + [(2, 80, 4, 16, 64), (1, 7, 2, 8, 64)])
def test_carried_state_matches_rwkv_chunked(B, S, H, K, chunk):
    """o and the final state against the LM's chunked recurrence, from a
    non-zero state; S=80 is a full chunk and a ragged 16-token tail."""
    d = _inputs(B, S, H, K, seed=2, state=True)
    jo, js = jssm.rwkv_chunked(*(jnp.asarray(d[n]) for n in ("r", "k", "v", "lw", "u", "s")),
                               chunk=chunk)
    to, ts = tops.wkv6(*(_t(d[n]) for n in ("r", "k", "v", "lw", "u", "s")), chunk=chunk)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("B,S,H,K,chunk", [(2, 50, 2, 8, 16), (1, 128, 4, 32, 64)])
def test_naive_matches_chunked_with_state(B, S, H, K, chunk):
    d = _inputs(B, S, H, K, seed=3, state=True)
    args = [_t(d[n]) for n in ("r", "k", "v", "lw", "u", "s")]
    o1, s1 = tref.wkv6_naive_ref(*args)
    o2, s2 = tref.wkv6_chunked_ref(*args, chunk=chunk)
    np.testing.assert_allclose(o2.numpy(), o1.numpy(), **TOL)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), **TOL)


def test_strong_decay_stays_finite():
    """Aggressive decays (log w = -20) must not produce inf/nan
    (tests/test_kernels.py:87-97), with and without a state."""
    d = _inputs(1, 32, 1, 8, state=True)
    lw = np.full_like(d["lw"], -20.0)
    for s in (None, _t(d["s"])):
        o, hT = tops.wkv6(_t(d["r"]), _t(d["k"]), _t(d["v"]), _t(lw),
                          torch.zeros(1, 8), s, chunk=16)
        assert torch.isfinite(o).all() and torch.isfinite(hT).all()


def test_bf16_inputs_run_in_float32_and_cpu_counts_no_launch():
    d = _inputs(1, 20, 2, 8)
    before = launch_counts()
    args = [_t(d[n]) for n in ("r", "k", "v", "lw", "u")]
    o32, s32 = tops.wkv6(*args)
    o16, s16 = tops.wkv6(*(a.bfloat16() for a in args[:3]), *args[3:])
    assert o16.dtype == s16.dtype == torch.float32
    np.testing.assert_allclose(o16.numpy(), o32.numpy(), rtol=5e-2, atol=5e-2)
    assert launch_counts() == before


def test_non_cpu_non_cuda_tensor_raises():
    x = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_chunked(x, x, x, x, torch.empty(2, 8, device="meta"))
