"""Port parity: the MoE FFN (``repro_torch.models.moe``) against the JAX
reference's ``repro.models.moe`` on the CPU, at the phi3.5-moe and grok-1
smoke configs.

Inputs are made from a numpy seed; the reference's parameters cross by
``convert.lm_params_from_jax`` (the MoE leaves of group 0, layer 0).  With
no mesh the reference's ``moe_ffn`` takes its dense path, as the port's
always does on one card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import moe

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b")
T = 24                       # tokens: 2 rows of 12


def _close(a, ref, tol):
    ref = np.asarray(ref, np.float32)
    a = a.float().numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(a - ref).max())
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol} * {scale:.3f}"


def _setup(arch, dtype):
    """(jax cfg, port cfg, the reference's MoE params of group 0 layer 0,
    the port's, (2, 12, d) activations in the compute dtype (numpy float32
    and torch))."""
    jc = dataclasses.replace(jget_smoke(arch), compute_dtype=dtype, param_dtype=dtype)
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype, param_dtype=dtype)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(7), jc))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["groups"]["L0"]["ffn"])
    tp = lm_params_from_jax(tree, tc, "cpu")["groups"][0]["L0"]["ffn"]
    x = np.random.default_rng(11).standard_normal((2, T // 2, tc.d_model)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(tc.cdtype)
    return jc, tc, jp, tp, xj, xt


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_shapes_and_dtypes(arch, pdtype):
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=pdtype)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    assert E == 4 and cfg.top_k == 2
    assert set(p) == {"router", "w_gate", "w_up", "w_down"}
    assert p["router"].shape == (d, E) and p["router"].dtype == torch.float32
    for name, shape in (("w_gate", (E, d, ff)), ("w_up", (E, d, ff)), ("w_down", (E, ff, d))):
        assert tuple(p[name].shape) == shape and p[name].dtype == cfg.pdtype, name
        # each expert drawn on its own: no two alike, std about 1/sqrt(fan-in)
        w = p[name].float()
        assert not torch.equal(w[0], w[1])
        assert abs(float(w.std()) * np.sqrt(shape[1]) - 1.0) < 0.1, name
    assert abs(float(p["router"].std()) * np.sqrt(d) - 1.0) < 0.2
    again = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_build_at_full_width(arch):
    """get_config builds both MoE archs, bf16 parameters by override (the
    experts' dtype), and the smoke config cuts the experts to min(E, 4)."""
    cfg = get_config(arch, "kernel-q3", param_dtype="bfloat16")
    assert cfg.pdtype == torch.bfloat16 and cfg.ffn_pattern == ("moe",)
    assert (cfg.n_experts, cfg.top_k) == ((16, 2) if arch.startswith("phi") else (8, 2))
    assert get_smoke_config(arch).n_experts == min(cfg.n_experts, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_reference(arch, dtype):
    """Expert indices equal to the reference's, weights within 1e-6."""
    jc, tc, jp, tp, xj, xt = _setup(arch, dtype)
    jw, je = jmoe._route(xj.reshape(-1, jc.d_model), jp["router"], jc)
    tw, te = moe._route(xt.reshape(-1, tc.d_model), tp["router"], tc)
    assert tw.dtype == torch.float32 and tuple(te.shape) == (T, tc.top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert np.allclose(tw.sum(-1).numpy(), 1.0)


@pytest.mark.parametrize("fn", ["moe_dense", "moe_ffn"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_reference_dense(arch, dtype, tol, fn):
    """moe_dense and moe_ffn against the reference's moe_dense (its
    moe_ffn with no mesh), in the compute dtype."""
    jc, tc, jp, tp, xj, xt = _setup(arch, dtype)
    ref = np.asarray(jmoe.moe_dense(jp, xj, jc), np.float32)
    y = getattr(moe, fn)(tp, xt, tc)
    assert y.dtype == tc.cdtype and tuple(y.shape) == tuple(xt.shape)
    _close(y, ref, tol)
    if fn == "moe_ffn":
        assert torch.equal(y, moe.moe_dense(tp, xt, tc))
        _close(y, np.asarray(jmoe.moe_ffn(jp, xj, jc), np.float32), tol)


def test_moe_rows_are_independent():
    """A token's output depends on its own activation alone: the rows of a
    batch equal the same rows run one at a time, bit for bit in bf16."""
    _, tc, _, tp, _, xt = _setup(MOE_ARCHS[0], "bfloat16")
    whole = moe.moe_dense(tp, xt, tc)
    for b in range(xt.shape[0]):
        assert torch.equal(whole[b:b + 1, :5], moe.moe_dense(tp, xt[b:b + 1, :5], tc))
