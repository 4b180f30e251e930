"""Port parity: Mamba, jamba's SSM layer (``repro_torch.models.ssm``'s
``init_mamba``, ``mamba_mix``, ``init_mamba_state``; the scan's plain
version ``kernels.ref.mamba_scan_ref``), and jamba as a whole, against the
JAX reference on the CPU.

Inputs are made from a numpy seed; the reference's parameters cross by
``convert.lm_params_from_jax``.  The reference evaluates the scan as an
associative scan over windows of ``mamba_chunk`` tokens, the port token by
token, so floats agree within the reference's tolerances and integer
artifacts (greedy tokens, router experts, engine schedules) exactly.  Its
kernel-q3 path runs its Pallas kernels in interpret mode, under the
``pltpu.TPUCompilerParams`` alias (as in ``tests/test_torch_lm.py``)."""
import contextlib
import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import launch_counts, ref
from repro_torch.kernels.mamba_scan import MambaScan
from repro_torch.launch import serve
from repro_torch.launch.engine import EpimEngine, Request
from repro_torch.models import lm, ssm
from repro_torch.pim.workloads import lm_layers
from repro_torch.train import loop
from repro_torch.train.tree import leaves

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ARCH = "jamba-1.5-large-398b"
F32_TOL = 1e-4              # tests/test_torch_lm.py
BF16_TOL = 5e-2             # tests/test_torch_lm.py
BF16_GRAD_TOL = 0.25        # tests/test_torch_train.py
CHUNK = 8                   # mamba_chunk of the mixer tests: S spans windows
PROMPT, NEW, MAX = 12, 3, 20
# the jamba smoke config without its MoE FFNs, as the card serves it: the
# engine chunks its prompts (across the scan's windows of CHUNK tokens)
DENSE = dict(ffn_pattern=("dense", "none") * 4, mamba_chunk=CHUNK)


def _close(a, ref_, tol):
    ref_ = np.asarray(ref_, np.float32)
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    scale = max(1.0, float(np.abs(ref_).max()))
    err = float(np.abs(a - ref_).max())
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol} * {scale:.3f}"


def _cfgs(variant="kernel-q3", **over):
    return (dataclasses.replace(jget_smoke(ARCH, variant), **over),
            dataclasses.replace(get_smoke_config(ARCH, variant), **over))


@contextlib.contextmanager
def _alias():
    """The reference's Pallas kernels in interpret mode look up
    ``pltpu.TPUCompilerParams``, renamed in jax 0.9: aliased for the
    block, never beyond it."""
    from jax.experimental.pallas import tpu as pltpu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        yield


# -- the scan's plain version ---------------------------------------------------
def _scan_inputs(B=2, S=19, di=12, ds=4, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    dt = torch.nn.functional.softplus(f(B, S, di)).to(dtype)
    A = -torch.exp(f(di, ds) * 0.5)
    return dt, f(B, S, di).to(dtype), f(B, S, ds).to(dtype), f(B, S, ds).to(dtype), A, \
        f(di), f(B, di, ds)


def _scan_f64(dt, x, Bm, Cm, A, D, h0):
    """The recurrence in float64, numpy, token by token."""
    dt, x, Bm, Cm, A, D, h = (np.asarray(t.double()) for t in (dt, x, Bm, Cm, A, D, h0))
    ys = []
    for t in range(dt.shape[1]):
        h = np.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None]
        ys.append((h * Cm[:, t, None]).sum(-1) + D * x[:, t])
    return np.stack(ys, 1), h


def test_scan_ref_matches_float64_recurrence():
    ins = _scan_inputs()
    y, hT = ref.mamba_scan_ref(*ins, chunk=CHUNK)
    y64, h64 = _scan_f64(*ins)
    assert y.dtype == hT.dtype == torch.float32
    assert tuple(y.shape) == (2, 19, 12) and tuple(hT.shape) == (2, 12, 4)
    np.testing.assert_allclose(y.numpy(), y64, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), h64, rtol=1e-5, atol=1e-5)
    y0, h0 = ref.mamba_scan_ref(*ins[:6], None)            # no state: zeros
    y64, h64 = _scan_f64(*ins[:6], torch.zeros_like(ins[6]))
    np.testing.assert_allclose(y0.numpy(), y64, rtol=1e-5, atol=1e-5)


def test_scan_ref_windows_splits_and_identity_pads_are_exact():
    """Checkpoint windows change no bit; a scan split at any token and
    carried through hT equals one call; dt = 0 leaves the state as it was;
    bf16 inputs equal float32 inputs of the same values."""
    dt, x, Bm, Cm, A, D, h0 = ins = _scan_inputs()
    y, hT = ref.mamba_scan_ref(*ins, chunk=19)
    for chunk in (1, 4, CHUNK):
        y2, h2 = ref.mamba_scan_ref(*ins, chunk=chunk)
        assert torch.equal(y, y2) and torch.equal(hT, h2), chunk
    for cut in (1, 8, 11):
        ya, ha = ref.mamba_scan_ref(dt[:, :cut], x[:, :cut], Bm[:, :cut], Cm[:, :cut], A, D, h0)
        yb, hb = ref.mamba_scan_ref(dt[:, cut:], x[:, cut:], Bm[:, cut:], Cm[:, cut:], A, D, ha)
        assert torch.equal(torch.cat([ya, yb], 1), y) and torch.equal(hb, hT), cut
    tail = dt.clone()
    tail[:, -7:] = 0.0
    _, h_tail = ref.mamba_scan_ref(tail, x, Bm, Cm, A, D, h0)
    _, h_before = ref.mamba_scan_ref(tail[:, :-7], x[:, :-7], Bm[:, :-7], Cm[:, :-7], A, D, h0)
    assert torch.equal(h_tail, h_before)
    bf = [t.bfloat16() for t in (dt, x, Bm, Cm)]
    yb, hb = ref.mamba_scan_ref(*bf, A, D, h0)
    yf, hf = ref.mamba_scan_ref(*(t.float() for t in bf), A, D, h0)
    assert torch.equal(yb, yf) and torch.equal(hb, hf)


def test_scan_autograd_function_differentiates_the_plain_version():
    """MambaScan's CPU backward is the plain gradient (ref.mamba_scan_bwd_ref,
    the reverse recurrence) bit for bit, and agrees with autograd through
    the plain forward at the kernel gate (2e-4 + 2e-4 |ref|), for every
    input; bf16 inputs get bf16 gradients."""
    for dtype in (torch.float32, torch.bfloat16):
        ins = [t.clone().requires_grad_(True) for t in _scan_inputs(dtype=dtype)]
        y, hT = MambaScan.apply(*ins, CHUNK)
        assert launch_counts()["mamba_scan"] == 0           # CPU: the plain version
        loss = (y * y.detach().sign()).sum() + hT.square().sum()
        got = torch.autograd.grad(loss, ins)
        assert launch_counts()["mamba_scan_bwd"] == 0
        plain = ref.mamba_scan_bwd_ref(*(t.detach() for t in ins), y.detach().sign(),
                                       2 * hT.detach(), chunk=CHUNK)
        y2, h2 = ref.mamba_scan_ref(*ins, chunk=CHUNK)
        want = torch.autograd.grad((y2 * y2.detach().sign()).sum() + h2.square().sum(), ins)
        assert torch.equal(y, y2.detach()) and torch.equal(hT, h2.detach())
        for i, (a, p, b) in enumerate(zip(got, plain, want)):
            assert a.dtype == ins[i].dtype and torch.equal(a, p.to(a.dtype)), i
            a, b = a.float(), b.float()
            assert bool(((a - b).abs() <= 2e-4 + 2e-4 * b.abs()).all()), i
    # the state alone, without y: dh0 is the decay product times dhT
    ins = [t.clone().requires_grad_(i == 6) for i, t in enumerate(_scan_inputs(S=3))]
    _, hT = MambaScan.apply(*ins, CHUNK)
    (g,) = torch.autograd.grad(hT.sum(), [ins[6]])
    dt, A = ins[0].detach(), ins[4].detach()
    want = torch.exp(dt.sum(1)[..., None] * A)
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)


# -- init_mamba and mamba_mix --------------------------------------------------------
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["off", "kernel-q3"])
def test_init_mamba_shapes_and_dtypes(variant, pdtype):
    _, tc = _cfgs(variant, param_dtype=pdtype)
    p = ssm.init_mamba(torch.Generator().manual_seed(0), tc, prefix="L0/mixer", device="cpu")
    d, di, ds, dc = tc.d_model, tc.mamba_d_inner, tc.mamba_d_state, tc.mamba_d_conv
    r = max(1, d // 16)
    assert set(p) == {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "A_log", "D",
                      "out_proj"}
    for name, (M, N) in {"in_proj": (d, 2 * di), "x_proj": (di, r + 2 * ds),
                         "dt_proj": (r, di), "out_proj": (di, d)}.items():
        lc = tc.ep(M, N, f"L0/mixer/{name}")
        w = p[name]["E" if lc.is_epitome else "W"]
        assert tuple(w.shape) == ((lc.spec.m, lc.spec.n) if lc.is_epitome else (M, N)), name
        assert w.dtype == tc.pdtype
    assert tuple(p["dt_proj"]["b"].shape) == (di,) and not p["dt_proj"]["b"].any()
    assert tuple(p["conv_w"].shape) == (dc, di) and p["conv_w"].dtype == tc.pdtype
    assert p["A_log"].dtype == p["D"].dtype == torch.float32
    j = jssm.init_mamba(jax.random.PRNGKey(0), _cfgs(variant, param_dtype=pdtype)[0])
    np.testing.assert_array_equal(p["A_log"].numpy(), np.asarray(j["A_log"]))
    np.testing.assert_array_equal(p["D"].numpy(), np.asarray(j["D"]))
    conv, h = ssm.init_mamba_state(tc, 3, "cpu")
    assert conv.dtype == tc.cdtype and tuple(conv.shape) == (3, dc - 1, di)
    assert h.dtype == torch.float32 and tuple(h.shape) == (3, di, ds)
    meta = ssm.init_mamba_state(tc, 3, "meta")
    assert [t.device.type for t in meta] == ["meta", "meta"]


# (state, S, valid_len): S = 20 spans windows of 8 with a ragged tail
MIX_CASES = [("none", 20, None), ("state", 1, None), ("state", 20, 13),
             ("state", 20, "tensor")]
# the smoke config at off, and at kernel-q3 with jamba's 16 states
MIX_CONFIGS = [("off", {}), ("kernel-q3", {"mamba_d_state": 16})]


@pytest.mark.parametrize("case", MIX_CASES, ids=lambda c: f"{c[0]}-S{c[1]}-{c[2]}")
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("variant,over", MIX_CONFIGS, ids=["off", "kernel-q3-ds16"])
def test_mamba_mix_matches_reference(variant, over, dtype, tol, case):
    kind, S, valid = case
    jc, tc = _cfgs(variant, compute_dtype=dtype, mamba_chunk=CHUNK, **over)
    jp = jssm.init_mamba(jax.random.PRNGKey(4), jc, prefix="L0/mixer")
    jp = jax.tree.map(np.asarray, jp)
    tp = lm_params_from_jax({"groups": {"L0": {"mixer": jax.tree.map(lambda a: a[None], jp)}}},
                            types.SimpleNamespace(n_groups=1), "cpu")["groups"][0]["L0"]["mixer"]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tc.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, tc.mamba_d_conv - 1, tc.mamba_d_inner)).astype(np.float32)
    h = rng.standard_normal((2, tc.mamba_d_inner, tc.mamba_d_state)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jstate = None if kind == "none" else (jnp.asarray(conv, jdt), jnp.asarray(h))
    tstate = None if kind == "none" else (torch.from_numpy(conv).to(tc.cdtype),
                                          torch.from_numpy(h))
    n = 13 if valid else None
    with _alias():
        jout, (jconv, jh) = jssm.mamba_mix(
            jp, jnp.asarray(x, jdt), jc, state=jstate, prefix="L0/mixer",
            valid_len=None if n is None else jnp.int32(n))
    tvalid = torch.tensor(n) if valid == "tensor" else n
    before = launch_counts()
    with torch.no_grad():
        out, (tconv, th) = ssm.mamba_mix(tp, torch.from_numpy(x).to(tc.cdtype), tc,
                                         state=tstate, prefix="L0/mixer", valid_len=tvalid)
    assert launch_counts() == before
    assert out.dtype == tc.cdtype and tuple(out.shape) == (2, S, tc.d_model)
    assert tconv.dtype == tc.cdtype and th.dtype == torch.float32
    _close(out, np.asarray(jout, np.float32), tol)
    _close(tconv, np.asarray(jconv, np.float32), tol)
    _close(th, np.asarray(jh), tol)


# -- jamba smoke, the whole model ------------------------------------------------------
_RUNS = {}


def runs(variant, **over):
    """(jax cfg, port cfg, jax params, port params, prompts, next tokens,
    reference (prefill logits, decode logits, generate tokens)) for jamba's
    smoke config at ``variant`` in float32, built once per module run."""
    key = (variant, tuple(sorted(over.items())))
    if key not in _RUNS:
        jc, tc = _cfgs(variant, compute_dtype="float32", **over)
        tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), jc))
        rng = np.random.default_rng(8)
        prompts = rng.integers(0, tc.vocab, (2, PROMPT)).astype(np.int32)
        nxt = rng.integers(0, tc.vocab, (2, 1)).astype(np.int32)
        with _alias():
            jp = jlm.prepack_params(jax.tree.map(jnp.asarray, tree), jc)
            logits, st = jlm.prefill(jp, jnp.asarray(prompts), jlm.init_decode_state(jc, 2, MAX),
                                     jc)
            logits2, _ = jlm.decode_step(jp, st, jnp.asarray(nxt), jnp.int32(PROMPT), jc)
            toks, _ = jserve.generate(jp, jc, jnp.asarray(prompts), MAX, NEW)
            out = jax.tree.map(np.array, (logits, logits2, toks))
        jax.clear_caches()
        tp = lm.prepack_params(lm_params_from_jax(tree, tc, "cpu"), tc)
        _RUNS[key] = (jc, tc, tree, tp, prompts, nxt, out)
    return _RUNS[key]


@pytest.mark.parametrize("variant", ["off", "kernel", "kernel-q3"])
def test_jamba_prefill_decode_and_greedy_tokens(variant):
    """Prefill and one decode step in float32, and greedy tokens equal to
    the reference's serve.generate; the decode state holds conv and h for
    each Mamba layer and K/V for the attention layer, as the reference's."""
    jc, tc, _, tp, prompts, nxt, (jl, jl2, jtoks) = runs(variant)
    assert lm.needs_prepack(tc) == (variant == "kernel-q3")
    before = launch_counts()
    with torch.no_grad():
        state = lm.init_decode_state(tc, 2, MAX, "cpu")
        jstate = jlm.init_decode_state(jc, 2, MAX)
        assert {lk: set(v) for lk, v in jstate.items()} == \
            {lk: set(v) for lk, v in state[0].items()}
        logits, st = lm.prefill(tp, torch.from_numpy(prompts), state, tc)
        logits2, _ = lm.decode_step(tp, st, torch.from_numpy(nxt), PROMPT, tc)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 1, tc.vocab)
    _close(logits, jl, F32_TOL)
    _close(logits2, jl2, F32_TOL)
    toks, _ = serve.generate(tp, tc, torch.from_numpy(prompts), MAX, NEW)
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    assert launch_counts() == before          # CPU tensors run the plain versions


def test_jamba_converter_keeps_every_leaf():
    """The whole tree crosses: each Mamba layer's projections (dt_proj's
    bias too), conv, A_log and D beside the attention, the MoE and dense
    FFNs and the norms; A_log and D stay float32 under bf16 parameters."""
    _, tc, tree, _, _, _, _ = runs("kernel-q3")
    n_ref = sum(int(np.prod(np.shape(l))) for l in jax.tree.leaves(tree))
    conv = lm_params_from_jax(tree, tc, "cpu")
    assert sum(t.numel() for t in leaves(conv)) == n_ref
    for g in range(tc.n_groups):
        m = conv["groups"][g]["L0"]["mixer"]
        for name in ("conv_w", "conv_b", "A_log", "D"):
            np.testing.assert_array_equal(m[name].numpy(), tree["groups"]["L0"]["mixer"][name][g])
        np.testing.assert_array_equal(m["dt_proj"]["b"].numpy(),
                                      tree["groups"]["L0"]["mixer"]["dt_proj"]["b"][g])
    # bf16 parameters, as the reference holds them (its float32 A_log and D)
    keep = lambda path, a: a if path[-1].key in ("A_log", "D") else a.astype(jnp.bfloat16)
    btree = jax.tree_util.tree_map_with_path(keep, tree)
    m = lm_params_from_jax(btree, tc, "cpu")["groups"][1]["L1"]["mixer"]
    assert m["A_log"].dtype == m["D"].dtype == torch.float32
    assert m["conv_w"].dtype == m["in_proj"]["E"].dtype == torch.bfloat16
    np.testing.assert_array_equal(m["conv_w"].float().numpy(),
                                  tree["groups"]["L1"]["mixer"]["conv_w"][1]
                                  .astype(jnp.bfloat16).astype(np.float32))
    with pytest.raises(KeyError, match="unknown LM parameter leaf"):
        lm_params_from_jax({"groups": {"L0": {"mixer": {"A_bad": np.zeros((2, 3))}}}}, tc, "cpu")


@pytest.mark.parametrize("arch", ["rwkv6-7b", "gemma2-2b", ARCH])
def test_plan_inventory_names_and_shapes_match_param_tree(arch):
    """Every inventory row names a real parameter-tree path whose dense
    weight has exactly the inventoried (rows, cols), in every group (the
    counterpart of tests/test_lm_plan.py's inventory contract)."""
    cfg = get_smoke_config(arch)
    inv = lm_layers(cfg)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert inv and len(params["groups"]) == cfg.n_groups
    for group in params["groups"]:
        for l in inv:
            leaf = group
            for k in l.name.split("/"):
                leaf = leaf[k]
            assert tuple(leaf["W"].shape) == (l.rows, l.cols), l.name
    if arch == ARCH:
        assert sum(l.name.endswith("/x_proj") for l in inv) == 7


def test_jamba_full_width_sites_and_state():
    """Published widths: x_proj (16384 x 544) plans kernel-exact to an
    8704 x 256 epitome, dt_proj (512 x 16384, with a bias) snaps to 512 x
    256, in_proj and out_proj to 2048 x 32768 and 4096 x 8192; the same
    specs as the reference's.  The state's shapes come from the meta device."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # the snaps
        port = lm.lm_layer_configs(get_config(ARCH, "kernel-q3"))
        theirs = jlm.lm_layer_configs(jget_config(ARCH, "kernel-q3"))
        cfg = get_config(ARCH, "kernel-q3", ffn_pattern=("dense", "none") * 4)
        epitomized = sum(lc.is_epitome for lc in lm.lm_layer_configs(cfg).values())
    assert list(port) == list(theirs)
    for name, lc in port.items():
        assert dataclasses.astuple(lc.spec) == dataclasses.astuple(theirs[name].spec), name
    got = {w: (port[f"L0/mixer/{w}"].spec.M, port[f"L0/mixer/{w}"].spec.N,
               port[f"L0/mixer/{w}"].spec.m, port[f"L0/mixer/{w}"].spec.n)
           for w in ("in_proj", "x_proj", "dt_proj", "out_proj")}
    assert got == {"in_proj": (8192, 32768, 2048, 32768), "x_proj": (16384, 544, 8704, 256),
                   "dt_proj": (512, 16384, 512, 256), "out_proj": (16384, 8192, 4096, 8192)}
    assert epitomized * cfg.n_groups == 63 * 4 + 9 * 4 + 36 * 3
    st = lm.init_decode_state(cfg, 4, 288, "meta")
    assert tuple(st[0]["L0"]["h"].shape) == (4, 16384, 16)
    assert tuple(st[0]["L0"]["conv"].shape) == (4, 3, 16384)


# -- the engine against one-shot ----------------------------------------------------
def _serve(eng, reqs):
    handles = [eng.submit(r) for r in reqs]
    eng.drain()
    return [h.result().tokens for h in handles]


_ENGINE = {}


def _engine_setup(layout):
    """(port cfg, port prepacked params) of jamba smoke at kernel-q3 in
    float32: its MoE layout (the reference's parameters) or DENSE."""
    if layout not in _ENGINE:
        if layout == "moe":
            _, tc, _, tp = runs("kernel-q3")[:4]
        else:
            tc = _cfgs("kernel-q3", compute_dtype="float32", **DENSE)[1]
            tp = lm.prepack_params(lm.init_params(torch.Generator().manual_seed(3), tc, "cpu"),
                                   tc)
        _ENGINE[layout] = (tc, tp)
    return _ENGINE[layout]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("layout", ["moe", "dense"])
def test_engine_matches_one_shot(layout, k):
    """jamba smoke (its MoE FFNs: every prompt prefilled whole at its
    length) and its MoE-free variant (prompts chunked across the scan's
    windows of 8 tokens): greedy tokens equal the port's one-shot generate
    (itself held to the reference's in test_jamba_prefill_decode_and_greedy_tokens)."""
    tc, tp = _engine_setup(layout)
    rng = np.random.default_rng(2)
    reqs = [Request(prompt=tuple(int(t) for t in rng.integers(0, tc.vocab, P)),
                    max_new_tokens=n) for P, n in ((5, 4), (19, 3), (30, 5))]
    eng = EpimEngine(tc, tp, capacity=2, max_len=48, page_size=16, prefill_chunk=8,
                     decode_block=k, device="cpu")
    got = _serve(eng, reqs)
    assert eng.chunk == (0 if layout == "moe" else CHUNK)
    assert eng.stats["prefill_chunks"] == (0 if layout == "moe" else 3 + 4)
    for i, r in enumerate(reqs):
        one, _ = serve.generate(tp, tc, torch.tensor([r.prompt]), eng.seq_len, r.max_new_tokens)
        assert got[i] == tuple(one[0].tolist()), i


# -- the loss and every gradient leaf ------------------------------------------------
_GRADS = {}


def _ref_grads(dtype):
    """(reference tree, numpy batch, the reference's loss and gradient
    leaves in the port's layout) of jamba smoke at folded-q3 in ``dtype``,
    jax.value_and_grad jitted, built once per module run."""
    if dtype not in _GRADS:
        jc, tc = _cfgs("folded-q3", compute_dtype=dtype)
        tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), jc))
        toks = np.random.default_rng(0).integers(0, tc.vocab, (2, 13)).astype(np.int32)
        mask = np.ones((2, 12), np.float32)
        mask[-1, -3:] = 0.0                   # a masked tail counts for nothing
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
        loss, g = jax.jit(jax.value_and_grad(jlm.loss_fn), static_argnums=2)(
            jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}, jc)
        grads = leaves(lm_params_from_jax(jax.tree.map(np.asarray, g), tc, "cpu"))
        _GRADS[dtype] = (tree, batch, float(loss), grads)
    return _GRADS[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    """jamba smoke at folded-q3: the loss and every gradient leaf (the Mamba
    layers' A_log, D, conv and projections among them) against
    jax.value_and_grad.  float32: each leaf within F32_TOL of its scale.
    bf16 (tests/test_torch_train.py's BF16_GRAD_TOL): each leaf within 0.25
    of its norm of the reference's bf16 gradient, or no further from the
    float32 gradient than the reference's own bf16 gradient is: the two
    frameworks round to bf16 in different places, and on this config the
    reference's bf16 gradient lies up to 0.41 of the norm from its float32
    one (the port's up to 0.32, the MoE router's)."""
    _, tc = _cfgs("folded-q3", compute_dtype=dtype)
    tree, batch, jloss, ref_ = _ref_grads(dtype)
    params = lm_params_from_jax(tree, tc, "cpu")
    loss, grads = loop.loss_and_grads(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      tc)
    got = leaves(grads)
    assert len(got) == len(ref_) == len(leaves(params))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert abs(float(loss) - jloss) <= tol * max(1.0, abs(jloss))
    f32 = None if dtype == "float32" else _ref_grads("float32")[3]
    for i, (a, r) in enumerate(zip(got, ref_)):
        assert a.dtype == r.dtype and a.shape == r.shape, i
        a, r = a.float(), r.float()
        assert bool(a.abs().max() > 0) == bool(r.abs().max() > 0), i
        if f32 is None:
            err, scale = float((a - r).abs().max()), float(r.abs().max())
            assert err <= F32_TOL * scale, f"leaf {i}: {err:.3e} > {F32_TOL} * {scale:.3e}"
            continue
        rel = lambda u, v: float((u - v).norm() / v.norm().clamp_min(1e-30))
        mine, theirs = rel(a, f32[i].float()), rel(r, f32[i].float())
        assert rel(a, r) <= BF16_GRAD_TOL or mine <= theirs, \
            f"leaf {i}: ||g - ref|| / ||ref|| = {rel(a, r):.3f}, from float32 {mine:.3f} " \
            f"(the reference's bf16 {theirs:.3f})"
