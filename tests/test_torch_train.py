"""Port parity: training (``lm.loss_fn`` and its gradient, ``repro_torch.
train``, ``launch.train``) against the JAX reference, on the CPU, where the
WKV runs its plain version forward and backward.

Reference gradients cross into the port's layout by
``convert.lm_params_from_jax``.  The two frameworks draw different random
numbers, so every input is made by numpy from a seed and handed to both."""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.train import loop, optimizer
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticData
from repro_torch.train.tree import leaves, tree_map

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

# float32: the LM parity tolerance (tests/test_torch_lm.py), taken relative
# to each gradient leaf's own scale; measured 4e-6 of it on these configs
F32_TOL = 1e-4
# bfloat16: the loss within the LM tests' BF16_TOL of its scale.  The
# gradients differ by where the frameworks round to 8 bits, forward and
# backward, through 2-4 layers; measured ||g - ref|| / ||ref|| per leaf up to
# 0.085 (rwkv6's u) and 0.17 (phi3.5-moe's router, a sum that cancels over
# each token's two experts, where one token of 32 in layer 1 routes to
# another expert at 'folded' as the two round its router input), so each
# leaf is held at 0.25 of its norm
BF16_TOL = 5e-2
BF16_GRAD_TOL = 0.25
ARCHS = ("rwkv6-7b", "qwen2-72b", "gemma2-2b", "deepseek-67b", "phi3.5-moe-42b-a6.6b")
B, S = 2, 16


def _numpy_tree(jc, seed=3):
    """The reference's init, with its zero-initialised leaves (rwkv6's LoRA
    and decay B's, qwen's biases) drawn non-zero so every input matters."""
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(5)

    def draw(node):
        for k, v in node.items():
            if isinstance(v, dict):
                draw(v)
            elif k in ("lora_B", "wd_B", "b"):
                node[k] = (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
    draw(tree)
    return tree


def _numpy_batch(vocab, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[-1, -3:] = 0.0                       # a masked tail counts for nothing
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _cfgs(arch, variant, dtype="float32"):
    return (dataclasses.replace(jget_smoke(arch, variant), compute_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch, variant), compute_dtype=dtype))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_loss_and_grads(jc, tree, batch):
    loss, g = jax.value_and_grad(jlm.loss_fn)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    return float(loss), jax.tree.map(np.asarray, g)


# -- the loss and every gradient leaf ----------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["folded", "folded-q3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, variant, dtype):
    jc, tc = _cfgs(arch, variant, dtype)
    tree, batch = _numpy_tree(jc), _numpy_batch(tc.vocab)
    jloss, jg = _ref_loss_and_grads(jc, tree, batch)
    params = lm_params_from_jax(tree, tc, "cpu")
    loss, grads = loop.loss_and_grads(params, _torch(batch), tc)
    ref = leaves(lm_params_from_jax(jg, tc, "cpu"))
    got = leaves(grads)
    assert len(got) == len(ref) == len(leaves(params))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert abs(float(loss) - jloss) <= tol * max(1.0, abs(jloss))
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == r.dtype == tc.pdtype and a.shape == r.shape, i
        a, r = a.float(), r.float()
        assert bool(a.abs().max() > 0) == bool(r.abs().max() > 0), i
        if dtype == "float32":
            err, scale = float((a - r).abs().max()), float(r.abs().max())
            assert err <= F32_TOL * scale, f"leaf {i}: {err:.3e} > {F32_TOL} * {scale:.3e}"
        else:
            rel = float((a - r).norm() / r.norm().clamp_min(1e-30))
            assert rel <= BF16_GRAD_TOL, f"leaf {i}: ||g - ref|| / ||ref|| = {rel:.3f}"


@pytest.mark.parametrize("arch", ["rwkv6-7b", "qwen2-72b"])
def test_remat_policies_give_the_same_gradient(arch):
    """forward(remat=False), remat_policy 'nothing' (the default) and 'dots'
    recompute the same values, so loss and gradients are equal bit for bit."""
    jc, tc = _cfgs(arch, "folded-q3")
    tree, batch = _numpy_tree(jc), _torch(_numpy_batch(tc.vocab))
    params = lm_params_from_jax(tree, tc, "cpu")
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    outs = []
    for policy, remat in (("nothing", False), ("nothing", True), ("dots", True)):
        cfg = dataclasses.replace(tc, remat_policy=policy)
        logits = lm.forward(params, batch["tokens"], cfg, remat=remat)
        outs.append((logits, torch.autograd.grad(logits.float().square().mean(), ps)))
    for logits, grads in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, outs[0][1]))
    with pytest.raises(ValueError, match="remat_policy"):
        lm.forward(params, batch["tokens"], dataclasses.replace(tc, remat_policy="all"))


def test_loss_without_mask_and_from_embeddings():
    """No mask: every token counts; musicgen-large takes (B, S, d)
    embeddings, as the reference's loss_fn does."""
    jc, tc = _cfgs("musicgen-large", "folded")
    tree = _numpy_tree(jc)
    rng = np.random.default_rng(2)
    batch = {"embeds": (0.5 * rng.standard_normal((B, S, tc.d_model))).astype(np.float32),
             "tokens": np.zeros((B, S), np.int32),
             "labels": rng.integers(0, tc.vocab, (B, S)).astype(np.int32)}
    jloss, _ = _ref_loss_and_grads(jc, tree, batch)
    with torch.no_grad():
        loss = lm.loss_fn(lm_params_from_jax(tree, tc, "cpu"), _torch(batch), tc)
    assert abs(float(loss) - jloss) <= F32_TOL * max(1.0, jloss)


# -- training: the kernel variants refuse a backward ---------------------------
@pytest.mark.parametrize("variant", ["kernel", "kernel-q3"])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "qwen2-72b"])
def test_kernel_variants_refuse_training_like_the_reference(arch, variant):
    """loss_fn's backward at kernel or kernel-q3 raises NotImplementedError,
    as jax.grad through the reference's pallas_call does; the loss itself
    is the reference's.  Training runs 'folded'/'folded-q3'."""
    from jax.experimental.pallas import tpu as pltpu
    jc, tc = _cfgs(arch, variant)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), jc))
    toks = np.random.default_rng(1).integers(0, tc.vocab, (2, 9)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        jloss = jlm.loss_fn(jax.tree.map(jnp.asarray, tree),
                            {k: jnp.asarray(v) for k, v in batch.items()}, jc)
        with pytest.raises(NotImplementedError):
            jax.grad(jlm.loss_fn)(jax.tree.map(jnp.asarray, tree),
                                  {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    jax.clear_caches()
    params = lm_params_from_jax(tree, tc, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    loss = lm.loss_fn(params, _torch(batch), tc)
    assert abs(float(loss.detach()) - float(jloss)) <= F32_TOL * max(1.0, abs(float(jloss)))
    with pytest.raises(NotImplementedError, match="inference-only"):
        loss.backward()


# -- the optimizer ---------------------------------------------------------------
def _opt_trees(param_dtype):
    rng = np.random.default_rng(7)
    p = {"w": rng.standard_normal((3, 300)).astype(np.float32),
         "n": rng.standard_normal((300,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in p.items()}
             for s in (0.5, 3.0, 0.01)]          # the second step is clipped
    # copies: the port updates in place, and jnp.asarray may share numpy's memory
    to_t = lambda t: {k: torch.tensor(v).to(getattr(torch, param_dtype)) for k, v in t.items()}
    to_j = lambda t: {k: jnp.asarray(v, jnp.dtype(param_dtype)) for k, v in t.items()}
    return p, grads, to_t, to_j


@pytest.mark.parametrize("moments,param_dtype", [("float32", "float32"), ("bfloat16", "float32"),
                                                 ("int8", "float32"), ("float32", "bfloat16")])
def test_adamw_matches_reference(moments, param_dtype):
    """Three steps (warmup, a clipped step, decay) at each moment dtype, and
    bf16 parameters with float32 masters: parameters, moments, masters,
    grad norm and lr against repro.train.optimizer; int8 codes equal."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, moments_dtype=moments)
    tcfg, jcfg = optimizer.AdamWConfig(**cfg), jopt.AdamWConfig(**cfg)
    p, grads, to_t, to_j = _opt_trees(param_dtype)
    tp, jp = to_t(p), to_j(p)
    ts, js = optimizer.adamw_init(tp, tcfg), jopt.adamw_init(jp, jcfg)
    assert ("master" in ts) == ("master" in js) == (param_dtype != "float32")
    for g in grads:
        tp, ts, tm = optimizer.adamw_update(tp, to_t(g), ts, tcfg)
        jp, js, jm = jopt.adamw_update(jp, to_j(g), js, jcfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    close = lambda a, b: np.testing.assert_allclose(
        a.float().numpy(), np.asarray(b, np.float32), rtol=1e-5, atol=1e-7)
    for k in p:
        close(tp[k], jp[k])
        assert tp[k].dtype == getattr(torch, param_dtype)
        if "master" in ts:
            close(ts["master"][k], js["master"][k])
        for role in ("m", "v"):
            mine, theirs = ts[role][k], js[role][k]
            if moments == "int8":
                np.testing.assert_array_equal(mine[0].numpy(), np.asarray(theirs[0]))
                close(mine[1], theirs[1])
            else:
                assert mine.dtype == getattr(torch, moments)
                close(mine, theirs)


def test_schedule_and_q8_match_reference():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100)
    for s in (0, 5, 10, 55, 100, 150):
        np.testing.assert_allclose(float(optimizer.schedule(optimizer.AdamWConfig(**cfg),
                                                            torch.tensor(s, dtype=torch.int32))),
                                   float(jopt.schedule(jopt.AdamWConfig(**cfg), jnp.int32(s))),
                                   rtol=1e-6)
    x = (np.random.default_rng(1).standard_normal((3, 700)) * 10).astype(np.float32)
    q, s = optimizer._q8(torch.from_numpy(x))
    jq, js = jopt._q8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    back = optimizer._dq8(q, s, x.shape)
    assert float((back - torch.from_numpy(x)).abs().max()) <= float(s.max()) + 1e-6


def test_compress_grads_ef_matches_reference():
    rng = np.random.default_rng(4)
    g = {"w": rng.standard_normal((4, 64)).astype(np.float32),
         "n": rng.standard_normal((64,)).astype(np.float32)}
    tres = {k: torch.zeros(v.shape) for k, v in g.items()}
    jres = {k: jnp.zeros(v.shape) for k, v in g.items()}
    for i in range(3):
        gi = {k: v * (1 + 0.1 * i) for k, v in g.items()}
        tdeq, tres = loop.compress_grads_ef({k: torch.from_numpy(v) for k, v in gi.items()}, tres)
        jdeq, jres = jloop.compress_grads_ef({k: jnp.asarray(v) for k, v in gi.items()}, jres)
        for k in g:
            np.testing.assert_allclose(tdeq[k].numpy(), np.asarray(jdeq[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]), rtol=1e-5, atol=1e-7)


# -- the train step -----------------------------------------------------------------
def _states(arch, variant, opt_kw, compress=False):
    """(reference config, AdamW config, train config, state) and the
    port's, from one numpy tree."""
    jc, tc = _cfgs(arch, variant)
    tree = _numpy_tree(jc)
    jcfg, tcfg = jopt.AdamWConfig(**opt_kw), optimizer.AdamWConfig(**opt_kw)
    jtc = jloop.TrainConfig(compress_grads=compress)
    ttc = loop.TrainConfig(compress_grads=compress)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jp, "opt": jopt.adamw_init(jp, jcfg), "step": jnp.zeros((), jnp.int32)}
    params = lm_params_from_jax(tree, tc, "cpu")
    tstate = {"params": params, "opt": optimizer.adamw_init(params, tcfg),
              "step": torch.zeros((), dtype=torch.int32)}
    if compress:
        jstate["ef_residual"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
        tstate["ef_residual"] = tree_map(torch.zeros_like, params)
    return (jc, jcfg, jtc, jstate), (tc, tcfg, ttc, tstate)


def test_train_step_matches_reference():
    """One make_train_step step of rwkv6-7b smoke folded-q3 (float32) from
    one state on one batch: loss, grad norm and the new parameters.  The
    step is held bit for bit to adamw_update on the port's own gradients,
    and against the reference's new parameters wherever the reference's
    clipped gradient is at least 100 eps: Adam's first update is g / (|g| +
    eps), so where |g| is a few eps it is a fraction of lr that the
    gradient's last bits (the host's summation order) set."""
    opt_kw = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    (jc, jcfg, jtc, jstate), (tc, tcfg, ttc, tstate) = _states("rwkv6-7b", "folded-q3", opt_kw)
    _, (_, _, _, parts) = _states("rwkv6-7b", "folded-q3", opt_kw)
    batch = _numpy_batch(tc.vocab, seed=1)
    _, jg = _ref_loss_and_grads(jc, jax.tree.map(np.asarray, jstate["params"]), batch)
    jstate, jm = jloop.make_train_step(jc, jcfg, jtc)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = loop.make_train_step(tc, tcfg, ttc)(tstate, _torch(batch))
    assert int(tstate["step"]) == int(jstate["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=F32_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    # the step is its parts, bit for bit
    _, grads = loop.loss_and_grads(parts["params"], _torch(batch), tc)
    optimizer.adamw_update(parts["params"], grads, parts["opt"], tcfg)
    for a, b in zip(leaves(tstate["params"]), leaves(parts["params"])):
        assert torch.equal(a, b)
    # against the reference, where its clipped gradient is at least 100 eps
    clip = min(1.0, tcfg.grad_clip / (float(jm["grad_norm"]) + 1e-9))
    ref = leaves(lm_params_from_jax(jax.tree.map(np.asarray, jstate["params"]), tc, "cpu"))
    g_ref = leaves(lm_params_from_jax(jg, tc, "cpu"))
    held = 0
    for a, r, g in zip(leaves(tstate["params"]), ref, g_ref):
        keep = (g.abs() * clip >= 100 * tcfg.eps).numpy()
        held += int(keep.sum())
        np.testing.assert_allclose(a.detach().numpy()[keep], r.numpy()[keep], rtol=1e-4,
                                   atol=1e-2 * opt_kw["lr"])
    # 59562 of 70336 elements here; the rest have a zero or near-zero gradient
    assert held > 0.8 * sum(p.numel() for p in leaves(tstate["params"]))


def test_compressed_train_step_is_its_parts():
    """With compress_grads the step is loss_and_grads, compress_grads_ef on
    the residual it carries, then adamw_update, bit for bit, twice (the
    residual of the first step feeds the second).  The int8 rounding makes
    the step discontinuous in the gradient (a code at a rounding edge moves
    its element by lr), so against the reference it is held through its
    parts: compress_grads_ef above, the uncompressed step here."""
    opt_kw = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    _, (tc, tcfg, ttc, state) = _states("rwkv6-7b", "folded-q3", opt_kw, compress=True)
    _, (_, _, _, parts) = _states("rwkv6-7b", "folded-q3", opt_kw, compress=True)
    step_fn = loop.make_train_step(tc, tcfg, ttc)
    for seed in (1, 2):
        batch = _torch(_numpy_batch(tc.vocab, seed=seed))
        state, m = step_fn(state, batch)
        loss, grads = loop.loss_and_grads(parts["params"], batch, tc)
        deq, parts["ef_residual"] = loop.compress_grads_ef(grads, parts["ef_residual"])
        _, _, pm = optimizer.adamw_update(parts["params"], deq, parts["opt"], tcfg)
        assert torch.equal(m["loss"], loss) and torch.equal(m["grad_norm"], pm["grad_norm"])
        assert any(bool(r.abs().max() > 0) for r in leaves(state["ef_residual"]))
        for a, b in zip(leaves([state["params"], state["opt"], state["ef_residual"]]),
                        leaves([parts["params"], parts["opt"], parts["ef_residual"]])):
            assert torch.equal(a, b)


def test_grad_accum_two_equals_one():
    """grad_accum=2 averages two microbatches' gradients; with every token
    counted the mean of their losses is the full batch's loss."""
    jc, tc = _cfgs("rwkv6-7b", "folded-q3")
    params = lm_params_from_jax(_numpy_tree(jc), tc, "cpu")
    batch = _numpy_batch(tc.vocab, seed=2, b=4)
    batch["mask"][:] = 1.0
    batch = _torch(batch)
    l1, g1 = loop.loss_and_grads(params, batch, tc, loop.TrainConfig(grad_accum=1))
    l2, g2 = loop.loss_and_grads(params, batch, tc, loop.TrainConfig(grad_accum=2))
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for a, b in zip(leaves(g2), leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6 * float(b.abs().max()))


# -- data -----------------------------------------------------------------------------
def test_synthetic_data_properties():
    d = SyntheticData(vocab=100, seq_len=16, global_batch=8, seed=1)
    b = d.batch(5)
    assert all(torch.equal(b[k], d.batch(5)[k]) for k in b)                # deterministic
    assert not torch.equal(b["tokens"], d.batch(6)["tokens"])               # steps differ
    assert not torch.equal(b["tokens"], SyntheticData(100, 16, 8, seed=2).batch(5)["tokens"])
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert tuple(b["labels"].shape) == (8, 16) and bool((b["mask"] == 1).all())
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])             # shifted by one
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 100
    parts = [d.host_batch(5, h, 4) for h in range(4)]
    for k in b:
        assert torch.equal(torch.cat([p[k] for p in parts]), b[k])          # a partition
    # the copy coin: token t is f(base t-1) where its coin shows heads, which
    # is f(token t-1) where the coin at t-1 showed tails: a quarter of them
    big = SyntheticData(vocab=1000, seq_len=256, global_batch=8).batch(0)
    toks = torch.cat([big["tokens"], big["labels"][:, -1:]], 1).long()
    follows = (toks[:, 1:] == (toks[:, :-1] * 31 + 7) % 1000).float().mean()
    assert 0.2 < float(follows) < 0.3
    assert "embeds" in SyntheticData(10, 4, 2, embed_dim=8).batch(0)


# -- checkpoints ------------------------------------------------------------------------
def _tree():
    return {"a": torch.arange(5, dtype=torch.int32), "b": [torch.ones(2, 3).bfloat16()],
            "q": (torch.tensor([1, -2], dtype=torch.int8), torch.tensor([0.5])),
            "s": torch.zeros((), dtype=torch.int32)}


def test_checkpoint_round_trip_keep_k_and_torn_writes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = _tree()
    mgr.save(3, tree, blocking=True)
    step, back = mgr.restore(tree)
    assert step == 3
    for a, b in zip(leaves(back), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(back["q"], tuple) and isinstance(back["b"], list)
    for s in (4, 5, 6):
        mgr.save(s, tree, blocking=True)
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000006"]
    os.makedirs(tmp_path / "step_00000009")            # a torn write: no DONE
    os.makedirs(tmp_path / "step_00000010.tmp")
    assert mgr.latest_step() == 6
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"a": tree["a"]})


def test_checkpoint_async_lands_from_a_host_copy(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    tree = {"w": torch.arange(4.0)}
    mgr.save(7, tree)
    tree["w"].add_(100.0)            # the loop goes on updating in place
    mgr.wait()
    assert mgr.latest_step() == 7
    assert torch.equal(mgr.restore(tree)[1]["w"], torch.arange(4.0))


def _smoke_run(tmp_path, n_steps, state=None, kill_at=None):
    jc, tc = _cfgs("rwkv6-7b", "folded-q3")
    opt = optimizer.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    tcfg = loop.TrainConfig(checkpoint_every=2, log_every=100)
    data = SyntheticData(vocab=tc.vocab, seq_len=8, global_batch=2, seed=3)
    if state is None:
        state = loop.init_state(torch.Generator().manual_seed(0), tc, opt, tcfg, "cpu")
    step_fn = loop.make_train_step(tc, opt, tcfg)
    if kill_at is not None:
        inner = step_fn

        def step_fn(st, batch):
            if int(st["step"]) == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return inner(st, batch)
    ckpt = CheckpointManager(str(tmp_path), async_write=True)
    state, hist = loop.train_loop(state, step_fn, data, n_steps, ckpt=ckpt, train_cfg=tcfg,
                                  log=lambda *a: None)
    return state, hist, ckpt, (tc, opt, tcfg)


def test_loss_decreases_smoke():
    """The port learns: rwkv6-7b smoke folded-q3, 25 steps at lr 2e-3 on
    the CPU (the reference's tests/test_train.py TestLoop, on the port's
    trained LM), the mean loss of the last five steps below that of the
    first five."""
    _, tc = _cfgs("rwkv6-7b", "folded-q3")
    opt = optimizer.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=30, weight_decay=0.0)
    tcfg = loop.TrainConfig(grad_accum=1, log_every=100)
    data = SyntheticData(vocab=tc.vocab, seq_len=32, global_batch=4)
    state = loop.init_state(torch.Generator().manual_seed(0), tc, opt, tcfg, "cpu")
    state, hist = loop.train_loop(state, loop.make_train_step(tc, opt, tcfg), data, 25,
                                  train_cfg=tcfg, log=lambda *a: None)
    assert len(hist["loss"]) == 25 and all(np.isfinite(hist["loss"]))
    assert np.mean(hist["loss"][-5:]) < np.mean(hist["loss"][:5])


def test_restart_resumes_bit_for_bit(tmp_path):
    """Four steps straight, against two steps, a checkpoint at step 2, a
    fresh state restored from it and two more steps: the same losses and
    parameters bit for bit."""
    full, hist, _, _ = _smoke_run(tmp_path / "a", 4)
    _, first, ckpt, (tc, opt, tcfg) = _smoke_run(tmp_path / "b", 2)
    assert ckpt.latest_step() == 2 and first["loss"] == hist["loss"][:2]
    fresh = loop.init_state(torch.Generator().manual_seed(9), tc, opt, tcfg, "cpu")
    step, restored = ckpt.restore(fresh)
    assert step == 2 and int(restored["step"]) == 2
    resumed, rest, _, _ = _smoke_run(tmp_path / "b", 4, state=restored)
    assert rest["loss"] == hist["loss"][2:]
    for a, b in zip(leaves(resumed), leaves(full)):
        assert torch.equal(a, b)
    assert int(resumed["opt"]["step"]) == 4


def test_sigterm_checkpoints_and_stops(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    state, hist, ckpt, _ = _smoke_run(tmp_path, 6, kill_at=2)
    assert len(hist["loss"]) == 3 and ckpt.latest_step() == 3 and int(state["step"]) == 3
    assert signal.getsignal(signal.SIGTERM) == before


# -- the driver ---------------------------------------------------------------------------
def test_train_cli_on_cpu_and_restart(tmp_path, capsys):
    args = ["--arch", "rwkv6-7b", "--smoke", "--epitome", "folded-q3", "--device", "cpu",
            "--seq", "8", "--batch", "2", "--ckpt-dir", str(tmp_path)]
    state, hist = train_cli.main(args + ["--steps", "10"])
    assert len(hist["loss"]) == 10 and all(np.isfinite(hist["loss"]))
    assert int(state["step"]) == 10 and CheckpointManager(str(tmp_path)).latest_step() == 10
    state, hist2 = train_cli.main(args + ["--steps", "12"])
    out = capsys.readouterr().out
    assert "[train] restored checkpoint at step 10" in out and "[train] done" in out
    assert len(hist2["loss"]) == 2 and int(state["step"]) == 12
