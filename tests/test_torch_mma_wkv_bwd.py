"""Kernel #4's gradient (csrc/wkv6_bwd.cu): the tensor-core model at every
WKV case, under strong decay, and one TF32 pass missing the gate.

The models and cases are ``tests/mma_models.py``'s; nothing here needs a
card."""
import pytest

from repro_torch.kernels import ref

from mma_models import (WKV, WKV_CASES, _jax_wkv_grads, _over, _within, _wkv_bwd_case,
                        wkv6_bwd_mma_model)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


@pytest.mark.parametrize("state", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,S,H,K,chunk", WKV_CASES)
def test_wkv6_bwd_tensor_core_model_holds_the_gate(B, S, H, K, chunk, bf16, state):
    """The backward kernel's chunked arithmetic (64-token chunks, factored
    decays, three TF32 passes, dlogw by one scan), with h0 and dhT or
    neither, within the WKV gate of the plain token-form gradient and of
    jax.grad of the reference's ``ssm.rwkv_chunked``."""
    args = _wkv_bwd_case(B, S, H, K, bf16, state)
    got = wkv6_bwd_mma_model(*args)
    for want in (ref.wkv6_chunked_bwd_ref(*args), _jax_wkv_grads(*args, chunk=chunk)):
        for name, y, r in zip(("dr", "dk", "dv", "dlogw", "du", "dh0"), got, want):
            assert y.shape == r.shape and _within(y, r), name


@pytest.mark.parametrize("bf16", [False, True])
def test_wkv6_bwd_model_under_strong_decay_stays_finite_and_within_the_gate(bf16):
    """log w = -20: every factor the model takes is exp of a non-positive
    exponent, so nothing overflows; the factors that underflow drop terms
    below 1e-38."""
    args = _wkv_bwd_case(1, 128, 2, 64, bf16, logw=-20.0)
    for y, r in zip(wkv6_bwd_mma_model(*args), ref.wkv6_chunked_bwd_ref(*args)):
        assert _within(y, r)


def test_one_tf32_pass_misses_the_wkv_gate_backward():
    """As for kernel #4: one TF32 pass (hi hi alone) in the backward's
    products falls outside 1e-3 at rwkv6-7b's head (7-38x the gate,
    dlogw the furthest), float32 or bf16 r, k, v."""
    for bf16 in (False, True):
        args = _wkv_bwd_case(1, 256, 2, 64, bf16)
        got = wkv6_bwd_mma_model(*args, passes=1)
        want = ref.wkv6_chunked_bwd_ref(*args)
        assert all(_over(y, r, WKV) for y, r in zip(got[:4], want[:4]))
