"""Mamba's selective scan (csrc/mamba_scan.cu): the exponent path against
float64, one pairwise tree over any lane split, and the model within the
fp32 gate of ref.mamba_scan_ref.

The models and cases are ``tests/mma_models.py``'s; nothing here needs a
card."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

from mma_models import (FP32, SCAN_EX2_ERR, SCAN_LOG2E, _scan_case, _within,
                        mamba_scan_model, scan_exp2)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


def test_scan_exponent_path_is_one_at_dt0_and_near_exp():
    """2^(dt fl(A log2 e)) is exactly 1 at dt = +-0 (the identity the
    engine's pads rely on) and, over dt and A of the LM's ranges (dt to
    20, |A| to 30, exponents down to -600), within SCAN_EX2_ERR plus the
    one rounding of A2 (|dt A| 2^-24) and of dt A2 (2^-24 |dt A|) of
    float64's exp(dt A)."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy(-np.exp(rng.uniform(-4.0, np.log(30.0), 4096)).astype(np.float32))
    dt = torch.from_numpy(np.exp(rng.uniform(-12.0, np.log(20.0), 4096)).astype(np.float32))
    A2 = A * SCAN_LOG2E
    for zero in (0.0, -0.0):
        assert bool((scan_exp2(torch.full_like(A2, zero) * A2) == 1.0).all())
    got = scan_exp2(dt * A2).double()
    z = dt.double() * A.double()
    want = torch.exp(z)
    normal = want > 2.0 ** -125
    tol = SCAN_EX2_ERR + 2 * z.abs() * 2.0 ** -24 + 2.0 ** -24
    assert bool(((got - want).abs() <= tol * want)[normal].all())
    assert bool((got[~normal] <= 2.0 ** -124).all())


def test_scan_model_tree_gives_the_same_bits_on_1_2_and_4_lanes():
    """The pairwise tree over the 16 states, split over 1, 2 or 4 lanes,
    is one tree: the same y and hT bits."""
    args = _scan_case(2, 24, 40, 16)
    y1, h1 = mamba_scan_model(*args, lanes=1)
    for lanes in (2, 4):
        y, h = mamba_scan_model(*args, lanes=lanes)
        assert torch.equal(y, y1) and torch.equal(h, h1)


@pytest.mark.parametrize("B,S,di,ds,state", [(2, 40, 300, 16, True), (3, 33, 100, 4, True),
                                             (2, 20, 64, 16, False), (1, 7, 1000, 4, False)])
def test_scan_model_holds_the_gate_and_dt0_is_the_identity(B, S, di, ds, state):
    """Within KERNEL_TOL (2e-4 + 2e-4 |ref|) of ``ref.mamba_scan_ref`` (y
    and hT), with and without a state, ragged di, ds 4 and 16; and dt = 0
    on the last 5 tokens leaves hT at the state before them, bit for
    bit."""
    args = _scan_case(B, S, di, ds, state)
    got, want = mamba_scan_model(*args), ref.mamba_scan_ref(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _within(a, b, FP32)
    dt, x, Bm, Cm, A, D, h0 = args
    tail = dt.clone()
    tail[:, -5:] = 0.0
    _, h_tail = mamba_scan_model(tail, x, Bm, Cm, A, D, h0)
    _, h_before = mamba_scan_model(*(t[:, :-5] for t in (tail, x, Bm, Cm)), A, D, h0)
    assert torch.equal(h_tail, h_before)
