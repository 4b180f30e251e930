"""Kernel #4, the chunked WKV (csrc/wkv6.cu): the sub-chunk factored decays and
three TF32 passes within the WKV gate of the plain version and of the JAX
reference's ssm.rwkv_chunked, under strong decay too, where one TF32 pass
misses it.

The models and cases are ``tests/mma_models.py``'s; nothing here needs a
card."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

from mma_models import WKV, WKV_CASES, _over, _within, _wkv_case, wkv6_mma_model
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,S,H,K,chunk", WKV_CASES)
def test_wkv6_tensor_core_model_holds_the_gate(B, S, H, K, chunk, bf16):
    """The sub-chunk factored decays and three TF32 passes, from a state,
    within the WKV gate of the plain version and of the JAX reference's
    ``ssm.rwkv_chunked``."""
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    args = _wkv_case(B, S, H, K, bf16)
    o, hT = wkv6_mma_model(*args, chunk=chunk)
    o_ref, h_ref = ref.wkv6_chunked_ref(*args, chunk=chunk)
    jo, jh = jssm.rwkv_chunked(*(jnp.asarray(t.numpy()) for t in args), chunk=chunk)
    for y, r in ((o, o_ref), (hT, h_ref), (o, torch.from_numpy(np.array(jo))),
                 (hT, torch.from_numpy(np.array(jh)))):
        assert _within(y, r)


def test_wkv6_model_under_strong_decay_stays_finite_and_within_the_gate():
    """log w = -20: a factor exp(c - cs) over up to 63 tokens underflows
    (exp(-1260)), and drops only terms below 1e-38."""
    args = _wkv_case(1, 128, 2, 64, logw=-20.0)
    o, hT = wkv6_mma_model(*args)
    o_ref, h_ref = ref.wkv6_chunked_ref(*args)
    assert _within(o, o_ref) and _within(hT, h_ref)


def test_one_tf32_pass_misses_the_wkv_gate():
    """Why each of kernel #4's products takes three TF32 passes (two with
    bf16 v, whose lo is 0): one pass (hi hi alone) falls outside 1e-3 at
    rwkv6-7b's head, whether r, k, v are float32 or bf16."""
    for bf16 in (False, True):
        args = _wkv_case(1, 256, 2, 64, bf16)
        o, _ = wkv6_mma_model(*args, passes=1)
        assert _over(o, ref.wkv6_chunked_ref(*args)[0], WKV)
