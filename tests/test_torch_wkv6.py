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


# -- the gradient -----------------------------------------------------------------
# the reference's WKV cases (tests/test_kernels.py:67-72, 85): ragged S = 50,
# K = 64 in one chunk of 64, each from a non-zero state
GRAD_CASES = [(1, 16, 1, 8, 8), (2, 50, 2, 8, 16), (2, 50, 2, 64, 64), (1, 80, 2, 16, 64)]


def _jax_grads(d, chunk):
    """jax.grad of sum(o * do) + sum(hT * dhT) through the LM's chunked
    recurrence, repro.models.ssm.rwkv_chunked."""
    import jax

    def f(r, k, v, lw, u, s):
        o, hT = jssm.rwkv_chunked(r, k, v, lw, u, s, chunk=chunk)
        return jnp.sum(o * d["do"]) + jnp.sum(hT * d["dh"])
    return [np.asarray(g) for g in jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(d[n]) for n in ("r", "k", "v", "lw", "u", "s")))]


def _grad_inputs(B, S, H, K, seed):
    d = _inputs(B, S, H, K, seed=seed, state=True)
    rng = np.random.default_rng(seed + 100)
    d["do"] = rng.standard_normal((B, S, H, K)).astype(np.float32)
    d["dh"] = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return d


@pytest.mark.parametrize("B,S,H,K,chunk", GRAD_CASES)
def test_bwd_ref_and_autograd_match_jax_grad(B, S, H, K, chunk):
    """wkv6_chunked_bwd_ref and the gradient of ops.wkv6 (through WKV6)
    against jax.grad of the reference's rwkv_chunked, at the WKV gate
    |g - ref| <= 1e-3 + 1e-3 |ref|."""
    d = _grad_inputs(B, S, H, K, seed=4)
    ref = _jax_grads(d, chunk)
    names = ("r", "k", "v", "lw", "u", "s")
    plain = tref.wkv6_chunked_bwd_ref(*(_t(d[n]) for n in names), _t(d["do"]), _t(d["dh"]))
    ins = [_t(d[n]).requires_grad_(True) for n in names]
    before = launch_counts()
    o, hT = tops.wkv6(*ins, chunk=chunk)
    assert o.grad_fn is not None and type(o.grad_fn).__name__ == "WKV6Backward"
    auto = torch.autograd.grad((o * _t(d["do"])).sum() + (hT * _t(d["dh"])).sum(), ins)
    assert launch_counts() == before          # CPU tensors: the plain versions
    for name, a, b, r in zip(names, plain, auto, ref):
        np.testing.assert_allclose(a.numpy(), r, **TOL, err_msg=f"plain d{name}")
        np.testing.assert_allclose(b.numpy(), r, **TOL, err_msg=f"autograd d{name}")


@pytest.mark.parametrize("B,S,H,K,chunk", [(2, 50, 2, 64, 64), (1, 7, 2, 12, 64)])
def test_bwd_ref_matches_autograd_of_the_chunked_plain_version(B, S, H, K, chunk):
    """The token-form gradient against torch.autograd through the chunked
    wkv6_chunked_ref (which kernel #4 mirrors); K = 12 and S = 7 ragged."""
    d = _grad_inputs(B, S, H, K, seed=5)
    names = ("r", "k", "v", "lw", "u", "s")
    ins = [_t(d[n]).requires_grad_(True) for n in names]
    o, hT = tref.wkv6_chunked_ref(*ins, chunk=chunk)
    auto = torch.autograd.grad((o * _t(d["do"])).sum() + (hT * _t(d["dh"])).sum(), ins)
    plain = tref.wkv6_chunked_bwd_ref(*(_t(d[n]) for n in names), _t(d["do"]), _t(d["dh"]))
    for name, a, r in zip(names, plain, auto):
        np.testing.assert_allclose(a.numpy(), r.numpy(), **TOL, err_msg=f"d{name}")


def test_wkv6_grads_in_each_inputs_dtype_and_zero_state():
    """bf16 r, k, v get bf16 gradients, logw and u float32; a zero state
    (None) has no gradient; an unused final state needs no dhT; without
    grad, or with nothing that requires it, ops.wkv6 records nothing."""
    d = _grad_inputs(1, 20, 2, 8, seed=6)
    rkv = [_t(d[n]).bfloat16().requires_grad_(True) for n in ("r", "k", "v")]
    lw, u = _t(d["lw"]).requires_grad_(True), _t(d["u"]).requires_grad_(True)
    o, hT = tops.wkv6(*rkv, lw, u)
    o.sum().backward()
    assert [t.grad.dtype for t in rkv] == [torch.bfloat16] * 3
    assert lw.grad.dtype == u.grad.dtype == torch.float32 and lw.grad.shape == lw.shape
    plain = tref.wkv6_chunked_bwd_ref(*(t.detach() for t in (*rkv, lw, u)), None,
                                      torch.ones(o.shape))
    for t, g in zip((*rkv, lw, u), plain):
        torch.testing.assert_close(t.grad, g.to(t.grad.dtype))
    with torch.no_grad():
        assert tops.wkv6(*rkv, lw, u)[0].grad_fn is None
    assert tops.wkv6(*(t.detach() for t in (*rkv, lw, u)))[0].grad_fn is None
