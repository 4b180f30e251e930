"""Port parity: the LMs of repro_torch (configs, per-site epitome specs,
prepack, prefill, decode, generate) against the JAX reference, with the
reference's parameters carried across by ``convert.lm_params_from_jax``:
rwkv6-7b, the six attention architectures with the dense FFN, and the two
with the MoE FFN (phi3.5-moe, grok-1).

The reference's kernel-q3 path runs its Pallas kernels in interpret mode,
which look up ``pltpu.TPUCompilerParams`` (renamed ``CompilerParams`` in
jax 0.9): the module-scoped ``reference`` fixture aliases it while this
file's reference runs are built, and clears jax's caches after."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.pim import plan as jplan
from repro.pim import workloads as jworkloads
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import launch_counts, ops as tops
from repro_torch.launch import serve
from repro_torch.models import common, lm, ssm
from repro_torch.models.config import EpitomeSettings
from repro_torch.pim import plan as tplan
from repro_torch.pim import workloads as tworkloads

# float32: the reference's fp32 kernel tolerance (tests/test_kernels.py:17-18)
# taken relative to the logits' scale; measured ~3e-6 on logits of ~2.5.
F32_TOL = 1e-4
# bfloat16 rounds every activation to 8 bits of mantissa (ulp 2^-8 of the
# value); the two frameworks round at different places through 2 x 8
# projections and the recurrences, which moved logits of ~2.5 by up to 3 ulp
# (0.047) in the CPU runs, so 5e-2 of the logits' scale.
BF16_TOL = 5e-2
PROMPT, NEW = 80, 6         # one full 64-token chunk and a ragged 16-token tail


def _close(a, ref, tol):
    ref = np.asarray(ref, np.float32)
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(a - ref).max())
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol} * {scale:.3f}"


def _numpy_params(cfg):
    """Reference init from a key, with the zero-initialised LoRA B's and
    decay B drawn non-zero so every input of the time mix matters."""
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(5)
    mixer = tree["groups"]["L0"]["mixer"]
    for name in ("lora_B", "wd_B"):
        mixer[name] = (mixer[name] + 0.05 * rng.standard_normal(mixer[name].shape)
                       ).astype(np.float32)
    return tree


def _reference_runs(variant):
    """{dtype: (jax cfg, port cfg, jax prepacked params, port prepacked
    params, prompts), "runs": {dtype: (prefill logits, greedy token, decode
    logits, float32 generate tokens)}} for the rwkv6-7b smoke config at
    ``variant``, the reference's Pallas kernels under the alias."""
    from jax.experimental.pallas import tpu as pltpu
    rng = np.random.default_rng(0)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        for dtype in ("float32", "bfloat16"):
            jc = dataclasses.replace(jget_smoke("rwkv6-7b", variant), compute_dtype=dtype)
            tc = dataclasses.replace(get_smoke_config("rwkv6-7b", variant),
                                     compute_dtype=dtype)
            tree = _numpy_params(jc)
            jp = jlm.prepack_params(jax.tree.map(jnp.asarray, tree), jc)
            tp = lm.prepack_params(lm_params_from_jax(tree, tc, "cpu"), tc)
            prompts = rng.integers(0, tc.vocab, (2, PROMPT)).astype(np.int32)
            out[dtype] = (jc, tc, jp, tp, prompts)
        out["runs"] = {}
        for dtype in ("float32", "bfloat16"):
            jc, _, jp, _, prompts = out[dtype]
            logits, st = jlm.prefill(jp, jnp.asarray(prompts), jlm.init_decode_state(jc, 2, 100), jc)
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            logits2, _ = jlm.decode_step(jp, st, tok, jnp.int32(PROMPT), jc)
            toks = None
            if dtype == "float32":
                toks, _ = jserve.generate(jp, jc, jnp.asarray(prompts), 100, NEW)
            out["runs"][dtype] = jax.tree.map(np.array, (logits, tok, logits2, toks))
    jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference runs at kernel-q3 (``_reference_runs``)."""
    return _reference_runs("kernel-q3")


@pytest.fixture(scope="module")
def reference_kernel():
    """The reference runs at kernel: unquantized epitomes through
    ``epitome_matmul`` (the reference's Pallas kernel, the port's kernel #3
    plain version), E cast to the compute dtype per call."""
    return _reference_runs("kernel")


# -- configuration: integer artifacts match exactly ---------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal(arch):
    assert ARCHS == J_ARCHS
    for port, ref in ((get_config(arch, "kernel-q3"), jget_config(arch, "kernel-q3")),
                      (get_smoke_config(arch, "folded"), jget_smoke(arch, "folded"))):
        mine, theirs = dataclasses.asdict(port), dataclasses.asdict(ref)
        assert set(theirs) - set(mine) == {"seq_shard_residual"}
        assert mine == {k: theirs[k] for k in mine}
        assert port.n_groups == ref.n_groups and port.hd == ref.hd
        assert port.full_pattern == ref.full_pattern
        assert ssm.recurrence_alignment(port) == jssm.recurrence_alignment(ref)
        assert port.cdtype == getattr(torch, str(ref.cdtype))
        assert [dataclasses.astuple(l) for l in tworkloads.lm_layers(port)] == \
            [dataclasses.astuple(l) for l in jworkloads.lm_layers(ref)]


@pytest.mark.parametrize("smoke", [False, True])
def test_site_specs_and_pack_blocks_equal(smoke):
    """Every projection site's spec (after the kernel-exact snap) and its
    pack blocks, at full width and in the smoke config."""
    get_p, get_r = (get_smoke_config, jget_smoke) if smoke else (get_config, jget_config)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # the snaps; see the test below
        port = lm.lm_layer_configs(get_p("rwkv6-7b", "kernel-q3"))
        ref = jlm.lm_layer_configs(get_r("rwkv6-7b", "kernel-q3"))
    assert list(port) == list(ref) and len(port) == 8
    for name, lc in port.items():
        r = ref[name]
        assert dataclasses.astuple(lc.spec) == dataclasses.astuple(r.spec), name
        assert (lc.mode, lc.quant.bits) == (r.mode, r.quant.bits) == ("kernel", 3)
        assert dataclasses.asdict(lc.quant) == dataclasses.asdict(r.quant)
        assert tops.pack_blocks(lc.spec, lc.quant) == jops.pack_blocks(r.spec, r.quant)
        assert tplan.pack_grid(lc.spec) == jplan.pack_grid(r.spec)
    if not smoke:
        assert {(lc.spec.m, lc.spec.n) for lc in port.values()} == \
            {(1024, 4096), (1024, 14336), (3584, 4096)}
        assert lm.needs_prepack(get_config("rwkv6-7b", "kernel-q3"))
        assert not lm.needs_prepack(get_config("rwkv6-7b", "folded-q3"))


def test_legalize_spec_matches_reference():
    from repro.core.epitome import plan_epitome as jplan_epitome
    from repro_torch.core.epitome import plan_epitome as tplan_epitome
    for M, N in [(4096, 4096), (4096, 14336), (14336, 4096), (768, 512), (96, 64)]:
        layer_t = tworkloads.LayerShape("x", 1, 1, M, N, 1, kind="fc")
        layer_j = jworkloads.LayerShape("x", 1, 1, M, N, 1, kind="fc")
        for patch in ((256, 256), (32, 32)):
            ts = tplan_epitome(M, N, 4.0, patch=patch)
            js = jplan_epitome(M, N, 4.0, patch=patch)
            a, ea = tplan.legalize_spec(layer_t, ts, patch)
            b, eb = jplan.legalize_spec(layer_j, js, patch)
            assert (a is None) == (b is None) and ea == eb
            if a is not None:
                assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_settings_warn_when_they_snap_a_spec():
    ep = EpitomeSettings(enabled=True, mode="kernel", quant_bits=3)
    with pytest.warns(UserWarning, match="snapped 4096x1024 -> 1024x4096"):
        lc = ep.layer_config(4096, 4096)
    assert (lc.spec.m, lc.spec.n) == (1024, 4096)
    assert EpitomeSettings(enabled=True).layer_config(64, 64).spec is None   # < min_params


def test_plans_and_other_layer_kinds_wait_for_their_slices():
    # plans no longer wait: plan= installs the plan's per-site configs
    plan = tplan.auto_plan("rwkv6-7b", target_cr=4.0, weight_bits=3)
    cfg = get_config("rwkv6-7b", "off", plan=plan)
    assert dict(cfg.layer_config) == dict(plan.layer_configs())
    assert lm.lm_layer_configs(cfg)["L0/ffn/wv"] == dict(plan.layer_configs())["L0/ffn/wv"]
    # the MoE FFN no longer waits (its slice is ported), nor does Mamba
    g = torch.Generator().manual_seed(0)
    moe_cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    params = lm.init_params(g, moe_cfg, "cpu")
    assert set(params["groups"][0]["L0"]["ffn"]) == {"router", "w_gate", "w_up", "w_down"}
    jamba = get_smoke_config("jamba-1.5-large-398b")
    params = lm.init_params(g, jamba, "cpu")
    assert set(params["groups"][0]["L0"]["mixer"]) == {
        "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "A_log", "D", "out_proj"}
    state = lm.init_decode_state(jamba, 1, 8, "cpu")
    di, dc, ds = jamba.mamba_d_inner, jamba.mamba_d_conv, jamba.mamba_d_state
    assert tuple(state[0]["L0"]["conv"].shape) == (1, dc - 1, di)
    assert tuple(state[0]["L0"]["h"].shape) == (1, di, ds)
    assert set(state[0]["L4"]) == {"k", "v"}


# -- parameters and prepack ----------------------------------------------------
def test_prepack_codes_equal(reference):
    """int8 codes exactly; scales and zeros to one float32 ulp (the
    reference packs inside a jitted vmap, ROADMAP.md section 3)."""
    jc, tc, jp, tp, _ = reference["float32"]
    sites = lm.lm_layer_configs(tc)
    assert len(tp["groups"]) == tc.n_groups == 2
    for g in range(tc.n_groups):
        for name in sites:
            layer, kind, w = name.split("/")
            a, b = tp["groups"][g][layer][kind][w], jp["groups"][layer][kind][w]
            np.testing.assert_array_equal(a["Eq"].numpy(), np.asarray(b["Eq"][g]))
            np.testing.assert_array_equal(a["E"].numpy(), np.asarray(b["E"][g]))
            for s in ("Es", "Ez"):
                np.testing.assert_allclose(a[s].numpy(), np.asarray(b[s][g]), rtol=1e-6, atol=0)


def test_converter_keeps_every_leaf_and_rejects_unknown_ones(reference):
    jc, tc, jp, tp, _ = reference["float32"]
    n_ref = sum(int(np.prod(np.shape(l))) for l in jax.tree.leaves(jp))
    n_port = sum(t.numel() for t in jax.tree.leaves(tp))
    assert n_port == n_ref
    bad = {"embed": np.zeros((2, 2)), "groups": {"L0": {"mystery": np.zeros((2, 3))}}}
    with pytest.raises(KeyError, match="mystery"):
        lm_params_from_jax(bad, tc, "cpu")


# -- logits and tokens -----------------------------------------------------------
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_prefill_and_decode_logits(reference, dtype, tol):
    _, tc, _, tp, prompts = reference[dtype]
    jl, jtok, jl2, _ = reference["runs"][dtype]
    before = launch_counts()
    logits, st = lm.prefill(tp, torch.from_numpy(prompts), lm.init_decode_state(tc, 2, 100, "cpu"), tc)
    assert logits.dtype == tc.cdtype and tuple(logits.shape) == (2, 1, tc.vocab)
    _close(logits, jl, tol)
    logits2, _ = lm.decode_step(tp, st, torch.from_numpy(jtok), PROMPT, tc)
    _close(logits2, jl2, tol)
    assert launch_counts() == before          # CPU tensors run the plain versions


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_kernel_variant_prefill_and_decode_logits(reference_kernel, dtype, tol):
    """rwkv6-7b smoke at ``kernel`` (not -q3): every projection through
    ops.epitome_matmul, held to the reference in float32 and bf16."""
    _, tc, _, tp, prompts = reference_kernel[dtype]
    jl, jtok, jl2, _ = reference_kernel["runs"][dtype]
    assert not lm.needs_prepack(tc) and all(lc.quant is None
                                            for lc in lm.lm_layer_configs(tc).values())
    logits, st = lm.prefill(tp, torch.from_numpy(prompts),
                            lm.init_decode_state(tc, 2, 100, "cpu"), tc)
    assert logits.dtype == tc.cdtype
    _close(logits, jl, tol)
    logits2, _ = lm.decode_step(tp, st, torch.from_numpy(jtok), PROMPT, tc)
    _close(logits2, jl2, tol)


def test_kernel_variant_greedy_tokens_equal_reference(reference_kernel):
    _, tc, _, tp, prompts = reference_kernel["float32"]
    toks, _ = serve.generate(tp, tc, torch.from_numpy(prompts), 100, NEW)
    np.testing.assert_array_equal(toks.numpy(), reference_kernel["runs"]["float32"][3])


def test_greedy_tokens_equal_reference_generate(reference):
    _, tc, _, tp, prompts = reference["float32"]
    toks, state = serve.generate(tp, tc, torch.from_numpy(prompts), 100, NEW)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (2, NEW)
    np.testing.assert_array_equal(toks.numpy(), reference["runs"]["float32"][3])
    assert len(state) == tc.n_groups


def test_decode_matches_own_forward(reference):
    """prefill + one decode step == the forward's logits at that position
    (tests/test_models.py:64 for the reference)."""
    _, tc, _, tp, prompts = reference["float32"]
    seq = torch.from_numpy(prompts[:, :41])
    with torch.no_grad():
        ref = lm.forward(tp, seq, tc)[:, 40]
        _, st = lm.prefill(tp, seq[:, :40], lm.init_decode_state(tc, 2, 48, "cpu"), tc)
        l2, _ = lm.decode_step(tp, st, seq[:, 40:41], 40, tc)
    torch.testing.assert_close(l2[:, 0], ref, rtol=2e-4, atol=2e-4)


def test_forward_matches_reference(reference):
    jc, tc, jp, tp, prompts = reference["float32"]
    from jax.experimental.pallas import tpu as pltpu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        ref = jlm.forward(jp, jnp.asarray(prompts[:, :20]), jc, remat=False)
    jax.clear_caches()
    with torch.no_grad():
        _close(lm.forward(tp, torch.from_numpy(prompts[:, :20]), tc), ref, F32_TOL)


def test_sampled_decode_follows_its_generator(reference):
    _, tc, _, tp, prompts = reference["float32"]
    p = torch.from_numpy(prompts[:, :16])
    draw = lambda seed: serve.generate(tp, tc, p, 40, 5, temperature=0.8,
                                       generator=torch.Generator().manual_seed(seed))[0]
    a, b = draw(1), draw(1)
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < tc.vocab


def test_serve_cli_on_cpu(capsys):
    toks = serve.main(["--arch", "rwkv6-7b", "--smoke", "--epitome", "kernel-q3",
                       "--device", "cpu", "--requests", "2", "--prompt-len", "8",
                       "--max-new-tokens", "3"])
    assert tuple(toks.shape) == (2, 3) and int(toks.max()) < 192
    out = capsys.readouterr().out
    assert "(prepacked)" in out and "tok/s" in out and "[serve] sample:" in out


# -- the attention architectures ---------------------------------------------
ATTN_ARCHS = ("qwen2-72b", "qwen1.5-110b", "gemma2-2b", "deepseek-67b",
              "musicgen-large", "internvl2-76b")
# 12 tokens run past gemma2's smoke window of 8 in prefill, and decode runs
# further past it
A_PROMPT, A_NEW, A_MAX = 12, 4, 20
_ATTN_RUNS = {}


def _attn_numpy_params(cfg):
    """Reference init from a key, with the zero-initialised biases (qwen's
    qkv_bias) drawn non-zero so they matter."""
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(6)

    def draw(node):
        for k, v in node.items():
            if isinstance(v, dict):
                draw(v)
            elif k == "b":
                node[k] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
    draw(tree)
    return tree


def _attn_inputs(cfg, rng, S):
    """(B, S) token ids, or (B, S, d) embeddings for the modality stubs."""
    if cfg.embed_inputs:
        return (0.5 * rng.standard_normal((2, S, cfg.d_model))).astype(np.float32)
    return rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)


def attn_runs(arch, bits):
    """{dtype: (jax cfg, port cfg, jax prepacked params, port prepacked
    params, prompt inputs, next input, token prompts, reference (prefill
    logits, decode logits, prefill state, decode state, float32 generate
    tokens))} for ``arch``'s smoke config at kernel-q3 and kv_cache_bits
    ``bits``, built once per module run with the reference's Pallas
    kernels under the alias."""
    if (arch, bits) in _ATTN_RUNS:
        return _ATTN_RUNS[(arch, bits)]
    from jax.experimental.pallas import tpu as pltpu
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        for dtype in ("float32", "bfloat16"):
            rng = np.random.default_rng(0)
            over = dict(compute_dtype=dtype, kv_cache_bits=bits)
            jc = dataclasses.replace(jget_smoke(arch, "kernel-q3"), **over)
            tc = dataclasses.replace(get_smoke_config(arch, "kernel-q3"), **over)
            tree = _attn_numpy_params(jc)
            jp = jlm.prepack_params(jax.tree.map(jnp.asarray, tree), jc)
            tp = lm.prepack_params(lm_params_from_jax(tree, tc, "cpu"), tc)
            seq = _attn_inputs(tc, rng, A_PROMPT + 1)
            prompts = rng.integers(0, tc.vocab, (2, A_PROMPT)).astype(np.int32)
            logits, st = jlm.prefill(jp, jnp.asarray(seq[:, :A_PROMPT]),
                                     jlm.init_decode_state(jc, 2, A_MAX), jc)
            logits2, st2 = jlm.decode_step(jp, st, jnp.asarray(seq[:, A_PROMPT:]),
                                           jnp.int32(A_PROMPT), jc)
            toks = None
            if dtype == "float32":
                toks, _ = jserve.generate(jp, jc, jnp.asarray(prompts), A_MAX, A_NEW)
            runs = jax.tree.map(np.array, (logits, logits2, st, st2, toks))
            out[dtype] = (jc, tc, jp, tp, seq[:, :A_PROMPT], seq[:, A_PROMPT:], prompts, runs)
    jax.clear_caches()
    _ATTN_RUNS[(arch, bits)] = out
    return out


def _port_prefill_decode(tc, tp, inputs, nxt):
    with torch.no_grad():
        state = lm.init_decode_state(tc, 2, A_MAX, "cpu")
        logits, st = lm.prefill(tp, torch.from_numpy(inputs), state, tc)
        snap = [{k: {n: t.clone() for n, t in v.items()} for k, v in g.items()} for g in st]
        logits2, st2 = lm.decode_step(tp, st, torch.from_numpy(nxt), A_PROMPT, tc)
    return logits, logits2, snap, st2


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_attention_archs_prefill_and_decode_logits(arch, bits, dtype, tol):
    """Prefill and one decode step, held to the reference; token ids, or
    embeddings for musicgen-large and internvl2-76b (the modality stubs)."""
    _, tc, _, tp, inputs, nxt, _, (jl, jl2, _, _, _) = attn_runs(arch, bits)[dtype]
    assert (inputs.ndim == 3) == tc.embed_inputs
    before = launch_counts()
    logits, logits2, _, _ = _port_prefill_decode(tc, tp, inputs, nxt)
    assert logits.dtype == tc.cdtype and tuple(logits.shape) == (2, 1, tc.vocab)
    _close(logits, jl, tol)
    _close(logits2, jl2, tol)
    assert launch_counts() == before          # CPU tensors run the plain versions


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_archs_kv_caches_match_reference(arch):
    """float32: after prefill and after one decode step every cache row
    matches the reference's (stacked over groups there, a list here); at
    kv_cache_bits=8 the int8 codes are equal and the fp16 scales match."""
    for bits in (16, 8):
        _, tc, _, tp, inputs, nxt, _, (_, _, jst, jst2, _) = attn_runs(arch, bits)["float32"]
        _, _, st, st2 = _port_prefill_decode(tc, tp, inputs, nxt)
        for mine, theirs in ((st, jst), (st2, jst2)):
            for g in range(tc.n_groups):
                for layer, leaves in mine[g].items():
                    assert set(leaves) == ({"k", "v", "k_s", "v_s"} if bits == 8 else {"k", "v"})
                    for name, t in leaves.items():
                        ref = theirs[layer][name][g]
                        if t.dtype == torch.int8:
                            np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
                        else:
                            np.testing.assert_allclose(t.float().numpy(), np.asarray(ref, np.float32),
                                                       rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_archs_greedy_tokens_equal_reference(arch, bits):
    _, tc, _, tp, _, _, prompts, runs = attn_runs(arch, bits)["float32"]
    toks, state = serve.generate(tp, tc, torch.from_numpy(prompts), A_MAX, A_NEW)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (2, A_NEW)
    np.testing.assert_array_equal(toks.numpy(), runs[4])
    assert len(state) == tc.n_groups


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_archs_decode_matches_own_forward(arch):
    """prefill + one decode step == the port's forward at that position
    (tests/test_models.py:67 for the reference), on embeddings for the
    modality stubs; gemma2's 12 tokens run past its window of 8."""
    _, tc, _, tp, inputs, nxt, _, _ = attn_runs(arch, 16)["float32"]
    seq = torch.from_numpy(np.concatenate([inputs, nxt], axis=1))
    with torch.no_grad():
        ref = lm.forward(tp, seq, tc)[:, A_PROMPT]
        _, st = lm.prefill(tp, seq[:, :A_PROMPT], lm.init_decode_state(tc, 2, A_MAX, "cpu"), tc)
        l2, _ = lm.decode_step(tp, st, seq[:, A_PROMPT:], A_PROMPT, tc)
        # the position as a device tensor, scalar or per row, changes nothing
        _, st = lm.prefill(tp, seq[:, :A_PROMPT], lm.init_decode_state(tc, 2, A_MAX, "cpu"), tc)
        l3, _ = lm.decode_step(tp, st, seq[:, A_PROMPT:], torch.tensor(A_PROMPT), tc)
        _, st = lm.prefill(tp, seq[:, :A_PROMPT], lm.init_decode_state(tc, 2, A_MAX, "cpu"), tc)
        l4, _ = lm.decode_step(tp, st, seq[:, A_PROMPT:], torch.tensor([A_PROMPT] * 2), tc)
    torch.testing.assert_close(l2[:, 0], ref, rtol=2e-4, atol=2e-4)
    assert torch.equal(l2, l3) and torch.equal(l2, l4)
    if arch == "gemma2-2b":
        assert tc.window < A_PROMPT and tc.pattern[0] == "attn_local"


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_archs_forward_matches_reference(arch):
    jc, tc, jp, tp, inputs, _, _, _ = attn_runs(arch, 16)["float32"]
    from jax.experimental.pallas import tpu as pltpu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        ref = jlm.forward(jp, jnp.asarray(inputs), jc, remat=False)
    jax.clear_caches()
    with torch.no_grad():
        _close(lm.forward(tp, torch.from_numpy(inputs), tc), ref, F32_TOL)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_archs_converter_keeps_every_leaf(arch):
    """The whole tree crosses: wq/wk/wv/wo with their biases, the dense
    FFN, the norms, and the head or (gemma2) the tied embedding."""
    _, tc, jp, tp, _, _, _, _ = attn_runs(arch, 16)["float32"]
    n_ref = sum(int(np.prod(np.shape(l))) for l in jax.tree.leaves(jp))
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == n_ref
    mixer = tp["groups"][0]["L0"]["mixer"]
    assert set(mixer) == {"wq", "wk", "wv", "wo"}
    assert ("b" in mixer["wq"]) == tc.qkv_bias and "b" not in mixer["wo"]
    assert set(tp["groups"][0]["L0"]["ffn"]) == {"w_gate", "w_up", "w_down"}
    assert ("head" in tp) != tc.tie_embeddings
    bad = {"embed": np.zeros((2, 2)), "groups": {"L0": {"mixer": {"wq": {"Q": np.zeros((1, 2, 2))}}}}}
    with pytest.raises(KeyError, match="'Q'"):
        lm_params_from_jax(bad, tc, "cpu")


@pytest.mark.parametrize("arch", ["qwen2-72b", "gemma2-2b"])
def test_serve_cli_attention_archs_on_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--smoke", "--epitome", "kernel-q3",
                       "--device", "cpu", "--requests", "2", "--prompt-len", "10",
                       "--max-new-tokens", "3"])
    assert tuple(toks.shape) == (2, 3) and int(toks.min()) >= 0 and int(toks.max()) < 192
    out = capsys.readouterr().out
    assert f"[serve] {arch} epitome=kernel-q3 (prepacked)" in out and "tok/s" in out


def test_generate_refuses_a_cache_too_short_for_its_tokens():
    _, tc, _, tp, _, _, prompts, _ = attn_runs("qwen2-72b", 16)["float32"]
    with pytest.raises(ValueError, match="needs? 15"):
        serve.generate(tp, tc, torch.from_numpy(prompts), A_PROMPT + A_NEW - 2, A_NEW)


def test_engine_arguments_wait_for_the_engine_slice():
    """The serving engine's three arguments, which raised until the engine
    slice, now run and match the reference (qwen2-72b smoke, float32):
    ``prefill(valid_len=)`` and ``prefill(chunk_start=)`` against the
    reference's prefill with the same argument, and ``decode_step(
    page_table=)`` over the prompt's caches cut into pages against the
    reference's dense decode (and the port's, bit for bit)."""
    jc, tc, jp, tp, inputs, nxt, _, (_, jl2, _, _, _) = attn_runs("qwen2-72b", 16)["float32"]
    x = torch.from_numpy(inputs)
    from jax.experimental.pallas import tpu as pltpu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        float_kv = lambda st: jax.tree.map(lambda t: t.astype(jnp.float32), st)
        ref = {"valid_len": jlm.prefill(jp, jnp.asarray(inputs), jlm.init_decode_state(jc, 2, A_MAX),
                                        jc, valid_len=jnp.int32(4))[0],
               "chunk_start": jlm.prefill(jp, jnp.asarray(inputs),
                                          float_kv(jlm.init_decode_state(jc, 2, A_MAX)), jc,
                                          chunk_start=jnp.int32(0))[0]}
    jax.clear_caches()
    with torch.no_grad():
        for kw in (dict(valid_len=4), dict(chunk_start=0)):
            state = lm.init_decode_state(tc, 2, A_MAX, "cpu")
            logits, _ = lm.prefill(tp, x, state, tc, **kw)
            _close(logits, ref[next(iter(kw))], F32_TOL)
        _, st = lm.prefill(tp, x, lm.init_decode_state(tc, 2, A_MAX, "cpu"), tc)
        page, pps = 4, A_MAX // 4                   # slot b owns pages b*pps .. b*pps + pps-1
        table = torch.arange(2 * pps, dtype=torch.int32).reshape(2, pps)
        paged = [{lk: {k: torch.cat([v.reshape(2 * pps, page, *v.shape[2:]),
                                     torch.zeros((1, page) + v.shape[2:], dtype=v.dtype)])
                       for k, v in layer.items()} for lk, layer in g.items()} for g in st]
        pos = torch.full((2,), A_PROMPT)
        l_paged, _ = lm.decode_step(tp, paged, torch.from_numpy(nxt), pos, tc, page_table=table)
        l_dense, _ = lm.decode_step(tp, st, torch.from_numpy(nxt), pos, tc)
    _close(l_paged, jl2, F32_TOL)
    assert torch.equal(l_paged, l_dense)


# -- the MoE architectures ---------------------------------------------------
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b")
MOE_VARIANTS = ("off", "kernel", "kernel-q3")
_MOE_RUNS = {}


def moe_runs(arch, variant):
    """(jax cfg, port cfg, jax params, port params, prompts (2, A_PROMPT),
    next tokens (2, 1), reference (prefill logits, decode logits, generate
    tokens)) for ``arch``'s smoke config at ``variant`` in float32, the
    reference's tree carried across (prepacked at kernel-q3), built once
    per module run with the reference's Pallas kernels under the alias."""
    if (arch, variant) in _MOE_RUNS:
        return _MOE_RUNS[(arch, variant)]
    from jax.experimental.pallas import tpu as pltpu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        rng = np.random.default_rng(8)
        jc = dataclasses.replace(jget_smoke(arch, variant), compute_dtype="float32")
        tc = dataclasses.replace(get_smoke_config(arch, variant), compute_dtype="float32")
        tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), jc))
        jp = jlm.prepack_params(jax.tree.map(jnp.asarray, tree), jc)
        tp = lm.prepack_params(lm_params_from_jax(tree, tc, "cpu"), tc)
        prompts = rng.integers(0, tc.vocab, (2, A_PROMPT)).astype(np.int32)
        nxt = rng.integers(0, tc.vocab, (2, 1)).astype(np.int32)
        logits, st = jlm.prefill(jp, jnp.asarray(prompts), jlm.init_decode_state(jc, 2, A_MAX), jc)
        logits2, _ = jlm.decode_step(jp, st, jnp.asarray(nxt), jnp.int32(A_PROMPT), jc)
        toks, _ = jserve.generate(jp, jc, jnp.asarray(prompts), A_MAX, A_NEW)
        runs = jax.tree.map(np.array, (logits, logits2, toks))
    jax.clear_caches()
    _MOE_RUNS[(arch, variant)] = (jc, tc, jp, tp, prompts, nxt, runs)
    return _MOE_RUNS[(arch, variant)]


@pytest.mark.parametrize("variant", MOE_VARIANTS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_archs_prefill_and_decode_logits(arch, variant):
    """Prefill and one decode step, float32, held to the reference; the
    decode state is the attention layers' K/V alone (the MoE FFN carries
    none), as the reference's."""
    jc, tc, _, tp, prompts, nxt, (jl, jl2, _) = moe_runs(arch, variant)
    assert lm.needs_prepack(tc) == (variant == "kernel-q3")
    before = launch_counts()
    with torch.no_grad():
        state = lm.init_decode_state(tc, 2, A_MAX, "cpu")
        assert all(set(layer) == {"k", "v"} for g in state for layer in g.values())
        jstate = jlm.init_decode_state(jc, 2, A_MAX)
        assert {lk: set(v) for lk, v in jstate.items()} == \
            {lk: set(v) for lk, v in state[0].items()}
        logits, st = lm.prefill(tp, torch.from_numpy(prompts), state, tc)
        logits2, _ = lm.decode_step(tp, st, torch.from_numpy(nxt), A_PROMPT, tc)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 1, tc.vocab)
    _close(logits, jl, F32_TOL)
    _close(logits2, jl2, F32_TOL)
    assert launch_counts() == before          # CPU tensors run the plain versions


@pytest.mark.parametrize("variant", MOE_VARIANTS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_archs_greedy_tokens_equal_reference(arch, variant):
    _, tc, _, tp, prompts, _, runs = moe_runs(arch, variant)
    toks, state = serve.generate(tp, tc, torch.from_numpy(prompts), A_MAX, A_NEW)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (2, A_NEW)
    np.testing.assert_array_equal(toks.numpy(), runs[2])
    assert len(state) == tc.n_groups


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_archs_converter_keeps_every_leaf(arch):
    """The whole tree crosses: the router and the (E, d, ff) experts of
    every group, beside the attention's epitomes and the norms."""
    _, tc, jp, tp, _, _, _ = moe_runs(arch, "kernel-q3")
    n_ref = sum(int(np.prod(np.shape(l))) for l in jax.tree.leaves(jp))
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == n_ref
    for g in range(tc.n_groups):
        f = tp["groups"][g]["L0"]["ffn"]
        assert tuple(f["w_gate"].shape) == (tc.n_experts, tc.d_model, tc.d_ff)
        assert tuple(f["w_down"].shape) == (tc.n_experts, tc.d_ff, tc.d_model)
        assert f["router"].dtype == torch.float32
        np.testing.assert_array_equal(f["w_up"].numpy(),
                                      np.asarray(jp["groups"]["L0"]["ffn"]["w_up"][g]))


def test_moe_bf16_parameters_as_the_card_serves_them():
    """phi3.5-moe smoke at kernel-q3 with bf16 parameters and compute, as
    the card serves the full model: the prepacked scales and zeros are the
    reference's bf16 values widened to the kernel's float32, the codes
    equal, and prefill and decode logits within BF16_TOL."""
    from jax.experimental.pallas import tpu as pltpu
    arch, over = "phi3.5-moe-42b-a6.6b", dict(param_dtype="bfloat16")
    jc = dataclasses.replace(jget_smoke(arch, "kernel-q3"), **over)
    tc = dataclasses.replace(get_smoke_config(arch, "kernel-q3"), **over)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), jc))
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, tc.vocab, (2, A_PROMPT)).astype(np.int32)
    nxt = rng.integers(0, tc.vocab, (2, 1)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        jp = jlm.prepack_params(jax.tree.map(jnp.asarray, tree), jc)
        jl, st = jlm.prefill(jp, jnp.asarray(prompts), jlm.init_decode_state(jc, 2, A_MAX), jc)
        jl2, _ = jlm.decode_step(jp, st, jnp.asarray(nxt), jnp.int32(A_PROMPT), jc)
    jax.clear_caches()
    tp = lm.prepack_params(lm_params_from_jax(tree, tc, "cpu"), tc)
    for g in range(tc.n_groups):
        for w in ("wq", "wk", "wv", "wo"):
            a, b = tp["groups"][g]["L0"]["mixer"][w], jp["groups"]["L0"]["mixer"][w]
            assert a["E"].dtype == torch.bfloat16 and a["Es"].dtype == a["Ez"].dtype == torch.float32
            np.testing.assert_array_equal(a["Eq"].numpy(), np.asarray(b["Eq"][g]))
            for s in ("Es", "Ez"):
                np.testing.assert_array_equal(a[s].numpy(), np.asarray(b[s][g], np.float32))
        assert tp["groups"][g]["L0"]["ffn"]["w_up"].dtype == torch.bfloat16
    with torch.no_grad():
        logits, st = lm.prefill(tp, torch.from_numpy(prompts),
                                lm.init_decode_state(tc, 2, A_MAX, "cpu"), tc)
        logits2, _ = lm.decode_step(tp, st, torch.from_numpy(nxt), A_PROMPT, tc)
    assert logits.dtype == torch.bfloat16
    _close(logits, np.asarray(jl, np.float32), BF16_TOL)
    _close(logits2, np.asarray(jl2, np.float32), BF16_TOL)


def test_serve_cli_moe_arch_on_cpu(capsys):
    toks = serve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--epitome", "kernel-q3",
                       "--device", "cpu", "--requests", "2", "--prompt-len", "10",
                       "--max-new-tokens", "3"])
    assert tuple(toks.shape) == (2, 3) and int(toks.min()) >= 0 and int(toks.max()) < 192
    out = capsys.readouterr().out
    assert "[serve] phi3.5-moe-42b-a6.6b epitome=kernel-q3 (prepacked)" in out


# -- shared pieces ---------------------------------------------------------------
def test_common_pieces_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = (rng.standard_normal(16) * 0.1).astype(np.float32)
    np.testing.assert_allclose(common.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)
    for name in ("silu", "gelu", "relu"):
        np.testing.assert_allclose(common.act_fn(name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(jcommon.act_fn(name)(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(common.softcap(torch.from_numpy(x) * 40, 30.0).numpy(),
                               np.asarray(jcommon.softcap(jnp.asarray(x) * 40, 30.0)),
                               rtol=1e-6, atol=1e-5)
    table = rng.standard_normal((10, 16)).astype(np.float32)
    ids = np.array([[1, 9, 3]], np.int32)
    np.testing.assert_array_equal(
        common.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids), torch.bfloat16).float().numpy(),
        np.asarray(jcommon.embed_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.bfloat16), np.float32))
    head = rng.standard_normal((16, 10)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        a = common.unembed(torch.from_numpy(x).to(dt), torch.from_numpy(head))
        b = jcommon.unembed(jnp.asarray(x, jdt), jnp.asarray(head))
        assert a.dtype == dt
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=1e-5 if dt == torch.float32 else 1e-2, atol=1e-5)
