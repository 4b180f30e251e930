"""Port parity: the selective scan's gradient (``kernels.ref.
mamba_scan_bwd_ref``, the plain version of ``csrc/mamba_scan_bwd.cu``;
``kernels.mamba_scan.MambaScan``'s backward) against autograd through the
scan's plain forward, and ``models.ssm.mamba_mix``'s gradient against
``jax.grad`` of the reference's ``mamba_mix`` on the CPU.

The gradient is the reverse recurrence with each window's states
recomputed by the plain forward; in float64 it equals autograd's within
rounding (1e-10), in float32 within the kernel gate (2e-4, ``|g - ref| <=
tol + tol |ref|``)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import launch_counts, ref
from repro_torch.kernels.mamba_scan import MambaScan, mamba_scan_bwd
from repro_torch.models import ssm
from repro_torch.train.tree import leaves

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ARCH = "jamba-1.5-large-398b"
KERNEL_TOL = 2e-4           # tests/test_kernels.py:17-18
F64_TOL = 1e-10
F32_TOL = 1e-4              # tests/test_torch_lm.py
CHUNK = 8                   # the plain version's window: S spans windows
GRADS = ("ddt", "dx", "dB", "dC", "dA", "dD", "dh0")

# (B, S, di, ds, h0, dy, dhT, dt = 0 on the last tokens): a state or none,
# either output's gradient missing, a ragged S across windows of CHUNK, one
# token, 4 states, a tail of identity pads
CASES = [
    (2, 21, 12, 4, True, True, True, 0),
    (2, 21, 12, 4, False, True, True, 0),
    (2, 21, 12, 4, True, False, True, 0),
    (2, 21, 12, 4, True, True, False, 0),
    (1, 1, 8, 16, True, True, True, 0),
    (3, 37, 20, 16, True, True, True, 5),
    (2, 16, 9, 3, False, True, False, 3),
]


def _inputs(B, S, di, ds, h0, dy, dhT, pads, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(dtype)
    dt = torch.nn.functional.softplus(f(B, S, di) - 1.0)
    if pads:
        dt[:, -pads:] = 0.0
    A = -torch.exp(f(di, ds) * 0.5)
    ins = [dt, f(B, S, di), f(B, S, ds), f(B, S, ds), A, f(di), f(B, di, ds) if h0 else None]
    return ins, f(B, S, di) if dy else None, f(B, di, ds) if dhT else None


def _autograd(ins, dy, dhT, chunk=CHUNK):
    """The gradients of <y, dy> + <hT, dhT> by autograd through the plain
    forward, zero where an input does not reach them."""
    req = [None if t is None else t.detach().clone().requires_grad_(True) for t in ins]
    y, hT = ref.mamba_scan_ref(*req, chunk=chunk)
    out = (0.0 if dy is None else (y * dy).sum()) + (0.0 if dhT is None else (hT * dhT).sum())
    wrt = [t for t in req if t is not None]
    got = iter(torch.autograd.grad(out, wrt, allow_unused=True))
    grads = [None if t is None else next(got) for t in req]
    return [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins) if t is not None]


def _hold(got, want, tol):
    for name, a, b in zip(GRADS, got, want):
        scale = tol + tol * b.abs()
        err = (a.to(b.dtype) - b).abs()
        assert bool((err <= scale).all()), f"{name}: max |g - ref| {float(err.max()):.3e}"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_scan_bwd_ref_matches_autograd_float64(case):
    ins, dy, dhT = _inputs(*case)
    got = ref.mamba_scan_bwd_ref(*ins, dy, dhT, chunk=CHUNK)
    assert all(g.dtype == torch.float64 for g in got)
    assert [tuple(g.shape) for g in got] == [tuple(t.shape) for t in ins[:6]] + [
        (case[0], case[2], case[3])]
    _hold(got, _autograd(ins, dy, dhT), F64_TOL)
    if ins[6] is None:                 # dh0 of a zero state: what a given zero state gets
        zero = torch.zeros(case[0], case[2], case[3], dtype=torch.float64)
        _hold(got[6:], _autograd(ins[:6] + [zero], dy, dhT)[6:], F64_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_scan_bwd_ref_matches_autograd_float32(case, dtype):
    """dt, x, B and C in float32 or bf16 (read as their float32 values); A,
    D, the state and the output gradients float32; the windows of the
    gradient (CHUNK) need not be the forward's (128)."""
    ins, dy, dhT = _inputs(*case, dtype=torch.float32)
    ins[:4] = [t.to(dtype) for t in ins[:4]]
    got = ref.mamba_scan_bwd_ref(*ins, dy, dhT, chunk=CHUNK)
    assert all(g.dtype == torch.float32 for g in got)
    want = _autograd([t if t is None else t.float() for t in ins], dy, dhT, chunk=128)
    _hold(got, want, KERNEL_TOL)


def test_scan_bwd_windows_and_the_wrapper_on_the_cpu():
    """The plain version's windows change no bit of ddt, dx, dB, dC or dh0
    (each window's states are the forward's); ``mamba_scan_bwd`` on CPU
    tensors is the plain version, no launch counted."""
    ins, dy, dhT = _inputs(2, 19, 12, 4, True, True, True, 0, dtype=torch.float32)
    one = ref.mamba_scan_bwd_ref(*ins, dy, dhT, chunk=19)
    for chunk in (1, 4, CHUNK):
        other = ref.mamba_scan_bwd_ref(*ins, dy, dhT, chunk=chunk)
        for name, a, b in zip(GRADS, other, one):
            if name in ("dA", "dD"):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
            else:
                assert torch.equal(a, b), (chunk, name)
    before = launch_counts()
    got = mamba_scan_bwd(*ins, dy, dhT, chunk=CHUNK)
    assert launch_counts() == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref.mamba_scan_bwd_ref(
        *ins, dy, dhT, chunk=CHUNK)))


def test_scan_bwd_cost_at_the_training_shape_is_the_kernels_note():
    """``kernels.cost``'s scratch and work of the gradient's kernel at
    jamba's training shape (8 x 256 tokens, di 16384, 16 states, bf16 dt,
    x, B, C, dy, no h0 or dhT) are the numbers the header of
    ``csrc/mamba_scan_bwd.cu`` states: 0.3445 GB of scratch, 1.372 GB and
    14.83 GFLOP of its own, 1.61 G exponentials."""
    from repro_torch.kernels import cost
    B, S, di, ds = 8, 256, 16384, 16
    assert cost.scan_bwd_scratch(B, S, di) == 344457216
    nbytes, ops = cost.scan_bwd_work(B, S, di, ds, 2, False, True, False)
    assert (nbytes, ops) == (1372127232.0, 14831058944.0)
    assert round(nbytes / cost.HBM_BW * 1e3, 2) == 0.41
    assert round(cost.SCAN_BWD_EXPS * B * S * di * ds / 1e9, 2) == 1.61


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_cpu_backward_is_the_plain_version(dtype):
    """MambaScan's backward on the CPU: the plain gradient bit for bit, cast
    to each input's dtype (dt, x, B, C in theirs; A, D, h0 float32), and
    only for the inputs that need one."""
    ins, dy, dhT = _inputs(2, 19, 12, 4, True, True, True, 0, dtype=torch.float32)
    ins[:4] = [t.to(dtype) for t in ins[:4]]
    req = [t.clone().requires_grad_(True) for t in ins]
    y, hT = MambaScan.apply(*req, CHUNK)
    got = torch.autograd.grad((y * dy).sum() + (hT * dhT).sum(), req)
    want = ref.mamba_scan_bwd_ref(*ins, dy, dhT, chunk=CHUNK)
    for a, b, t in zip(got, want, ins):
        assert a.dtype == t.dtype and torch.equal(a, b.to(t.dtype))
    req = [t.clone().requires_grad_(i in (1, 6)) for i, t in enumerate(ins)]
    y, hT = MambaScan.apply(*req, CHUNK)
    dx, dh0 = torch.autograd.grad(hT.sum(), [req[1], req[6]])
    want = ref.mamba_scan_bwd_ref(*ins, None, torch.ones_like(dhT), chunk=CHUNK)
    assert torch.equal(dx, want[1].to(dtype)) and torch.equal(dh0, want[6])


# -- mamba_mix's gradient against jax.grad -------------------------------------------
# (state, valid_len): S = 20 spans windows of CHUNK with a ragged tail
MIX_CASES = [("state", None), ("none", None), ("state", 13)]


@pytest.mark.parametrize("kind,valid", MIX_CASES, ids=lambda c: str(c))
def test_mamba_mix_gradient_matches_reference(kind, valid):
    """The jamba smoke config's Mamba block (16 states), float32, with a
    carried state and mamba_chunk 8: the gradient of <out, R> + <h', Q> +
    <conv', P> with respect to every parameter, the input and the carried
    state, against jax.grad of the reference's mamba_mix, each leaf within
    F32_TOL of its scale.  Pads past valid_len get dt = 0 and no gradient
    through dt (the reference's jnp.where)."""
    over = dict(compute_dtype="float32", mamba_chunk=CHUNK, mamba_d_state=16)
    import dataclasses
    jc = dataclasses.replace(jget_smoke(ARCH, "off"), **over)
    tc = dataclasses.replace(get_smoke_config(ARCH, "off"), **over)
    S = 20
    jp = jax.tree.map(np.asarray, jssm.init_mamba(jax.random.PRNGKey(5), jc, prefix="L0/mixer"))
    to_port = lambda tree: lm_params_from_jax(
        {"groups": {"L0": {"mixer": jax.tree.map(lambda a: a[None], tree)}}},
        types.SimpleNamespace(n_groups=1), "cpu")["groups"][0]["L0"]["mixer"]
    tp = to_port(jp)
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, conv, h = f(2, S, tc.d_model), f(2, tc.mamba_d_conv - 1, tc.mamba_d_inner), \
        f(2, tc.mamba_d_inner, tc.mamba_d_state)
    R, Q, P = f(2, S, tc.d_model), f(*h.shape), f(*conv.shape)

    def jloss(p, x, conv, h):
        out, (c2, h2) = jssm.mamba_mix(p, x, jc, state=None if kind == "none" else (conv, h),
                                       prefix="L0/mixer",
                                       valid_len=None if valid is None else jnp.int32(valid))
        return (out * R).sum() + (h2 * Q).sum() + (c2 * P).sum()
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                               jnp.asarray(conv), jnp.asarray(h))
    jgp, jgx, jgc, jgh = jax.tree.map(np.asarray, jg)

    params = leaves(tp)
    for p in params:
        p.requires_grad_(True)
    tx, tconv, th = (torch.from_numpy(a).requires_grad_(True) for a in (x, conv, h))
    out, (c2, h2) = ssm.mamba_mix(tp, tx, tc, state=None if kind == "none" else (tconv, th),
                                  prefix="L0/mixer", valid_len=valid)
    loss = (out * torch.from_numpy(R)).sum() + (h2 * torch.from_numpy(Q)).sum() \
        + (c2 * torch.from_numpy(P)).sum()
    wrt = params + [tx] + ([] if kind == "none" else [tconv, th])
    got = torch.autograd.grad(loss, wrt)
    want = [torch.from_numpy(np.asarray(a)) for a in leaves(to_port(jgp))] + [jgx] + (
        [] if kind == "none" else [jgc, jgh])
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = torch.as_tensor(np.array(b))
        assert a.shape == b.shape, i
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        assert err <= F32_TOL * scale, f"leaf {i}: {err:.3e} > {F32_TOL} * {scale:.3e}"
