"""Port parity: the serving engine (``repro_torch.launch.engine``) and its
model-side arguments (``lm.prefill(valid_len=, chunk_start=)``,
``lm.decode_step(page_table=)``, ``lm.decode_scan``) on the CPU at smoke
size, case by case as ``tests/test_engine.py`` and
``tests/test_paged_pool.py`` hold the reference's engine.

The reference's parameters cross by ``convert.lm_params_from_jax``.  The
port's engine is held to the reference's one-shot ``serve.generate`` and
``lm.prefill``, never to the reference's ``EpimEngine``, whose host race
(ROADMAP.md section 3) flips its results between runs.  Greedy tokens
equal the reference's one-shot tokens and the port's own; sampled tokens
(a ``torch.Generator`` per request, which JAX's draws cannot match) equal
the port's own one-shot ``serve.generate`` given a generator seeded alike.

The reference's kernel-q3 path runs its Pallas kernels in interpret mode,
under the test-scoped ``pltpu.TPUCompilerParams`` alias (as in
``tests/test_torch_lm.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import engine as engine_mod
from repro_torch.launch import plan as plan_cli
from repro_torch.launch import serve
from repro_torch.launch.engine import (Completion, EngineConfig, EpimEngine, Request,
                                       RequestHandle)
from repro_torch.models import lm

F32_TOL = 1e-4          # tests/test_torch_lm.py: float32 logits against the reference
# per arch: (KV rows of a slot, prefill chunk, requests (prompt length,
# max_new_tokens, temperature)); rwkv6-7b's chunk is its 64-token window, so
# its long prompt takes two chunks, qwen2-72b's three; phi3.5-moe's engine
# prefills every prompt whole at its exact length (the MoE rule), whatever
# chunk it is given
ARCHS = {
    "rwkv6-7b": (96, 64, ((5, 6, 0.0), (9, 5, 0.0), (70, 4, 0.0), (13, 9, 0.0),
                          (7, 6, 0.9), (66, 5, 1.2))),
    "qwen2-72b": (48, 16, ((6, 6, 0.0), (11, 5, 0.0), (35, 4, 0.0), (21, 8, 0.0),
                           (9, 5, 0.8), (20, 6, 1.1))),
    "phi3.5-moe-42b-a6.6b": (48, 16, ((6, 6, 0.0), (11, 5, 0.0), (35, 4, 0.0), (21, 8, 0.0),
                                      (9, 5, 0.8), (20, 6, 1.1))),
}
MOE = "phi3.5-moe-42b-a6.6b"
_SETUP, _REF_TOKENS = {}, {}


def setup(arch, dtype="float32"):
    """(jax cfg, port cfg, jax prepacked params, port prepacked params) of
    ``arch``'s kernel-q3 smoke config, the reference's tree carried across;
    built once per module run."""
    if (arch, dtype) not in _SETUP:
        jc = dataclasses.replace(jget_smoke(arch, "kernel-q3"), compute_dtype=dtype)
        tc = dataclasses.replace(get_smoke_config(arch, "kernel-q3"), compute_dtype=dtype)
        tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), jc))
        jp = jlm.prepack_params(jax.tree.map(jnp.asarray, tree), jc)
        tp = lm.prepack_params(lm_params_from_jax(tree, tc, "cpu"), tc)
        _SETUP[(arch, dtype)] = (jc, tc, jp, tp)
    return _SETUP[(arch, dtype)]


@pytest.fixture
def pallas_alias(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    yield
    jax.clear_caches()


def _requests(arch, seed=0):
    vocab = get_smoke_config(arch).vocab
    rng = np.random.default_rng(seed)
    return [Request(prompt=tuple(int(t) for t in rng.integers(0, vocab, P)),
                    max_new_tokens=n, temperature=t, seed=100 + i)
            for i, (P, n, t) in enumerate(ARCHS[arch][2])]


def _engine(arch, dtype="float32", **kw):
    _, tc, _, tp = setup(arch, dtype)
    kw.setdefault("max_len", ARCHS[arch][0])
    kw.setdefault("prefill_chunk", ARCHS[arch][1])
    kw.setdefault("page_size", 16)
    return EpimEngine(tc, tp, device="cpu", **kw)


def _port_one_shot(eng, req):
    """The port's one-shot serve.generate of the request alone, over the
    engine's KV rows, sampled from a generator seeded as the engine seeds
    it."""
    gen = torch.Generator().manual_seed(req.seed) if req.temperature > 0 else None
    toks, _ = serve.generate(eng.serve_params, eng.cfg, torch.tensor([req.prompt]),
                             eng.seq_len, req.max_new_tokens,
                             temperature=req.temperature, generator=gen)
    return tuple(toks[0].tolist())


def _reference_one_shot(arch, req, max_len):
    """The reference's greedy one-shot serve.generate (float32), cached."""
    key = (arch, req.prompt, req.max_new_tokens, max_len)
    if key not in _REF_TOKENS:
        jc, _, jp, _ = setup(arch)
        toks, _ = jserve.generate(jp, jc, jnp.asarray([req.prompt], jnp.int32), max_len,
                                  req.max_new_tokens)
        _REF_TOKENS[key] = tuple(int(t) for t in np.asarray(toks)[0])
    return _REF_TOKENS[key]


def _serve(eng, reqs, order=None):
    """Submit ``reqs`` in ``order`` and drain; {request index: tokens}."""
    order = range(len(reqs)) if order is None else order
    handles = {i: eng.submit(reqs[i]) for i in order}
    eng.drain()
    return {i: h.result().tokens for i, h in handles.items()}


def _close(a, ref, tol=F32_TOL):
    ref = np.asarray(ref, np.float32)
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(a - ref).max())
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol} * {scale:.3f}"


# -- the model's engine arguments against the reference -------------------------
def _j_state(jc, rows, float_kv):
    state = jlm.init_decode_state(jc, 1, rows)
    if not float_kv:
        return state
    return {lk: {k: (v.astype(jnp.float32) if k in ("k", "v") else v)
                 for k, v in layer.items()} for lk, layer in state.items()}


def _compare_states(tc, mine, theirs, rows=None):
    for g in range(tc.n_groups):
        for lk, layer in mine[g].items():
            for name, t in layer.items():
                a, b = t, np.asarray(theirs[lk][name][g])
                if rows is not None and name in ("k", "v"):
                    a, b = a[:, :rows], b[:, :rows]
                np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32),
                                           rtol=1e-4, atol=1e-5, err_msg=f"{lk}/{name}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_valid_len_matches_reference(arch, pallas_alias):
    """A 13-token prompt right-padded to its bucket of 16: logits at the
    last real row and the carried state, against the reference's prefill
    with the same valid_len; and the same as the unpadded prefill."""
    jc, tc, jp, tp = setup(arch)
    rng = np.random.default_rng(1)
    P, L, rows = 13, 16, 32
    buf = np.zeros((1, L), np.int32)
    buf[0, :P] = rng.integers(0, tc.vocab, P)
    jl, jst = jlm.prefill(jp, jnp.asarray(buf), jlm.init_decode_state(jc, 1, rows), jc,
                          valid_len=jnp.int32(P))
    with torch.no_grad():
        for valid in (P, torch.tensor(P)):       # an int or a 0-d tensor
            tl, tst = lm.prefill(tp, torch.from_numpy(buf), lm.init_decode_state(tc, 1, rows, "cpu"),
                                 tc, valid_len=valid)
            _close(tl, jl)
            _compare_states(tc, tst, jst, rows=P)
        exact, _ = lm.prefill(tp, torch.from_numpy(buf[:, :P]),
                              lm.init_decode_state(tc, 1, rows, "cpu"), tc)
    _close(tl, exact.numpy())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_chunks_match_reference(arch, pallas_alias):
    """A prompt over 2-3 chunks, the last one partial: each chunk's logits
    and the carried state against the reference's prefill(chunk_start=,
    valid_len=), from a state whose attention K/V are float32."""
    jc, tc, jp, tp = setup(arch)
    rows, chunk, _ = ARCHS[arch]
    P = {"rwkv6-7b": 70, "qwen2-72b": 35, MOE: 35}[arch]
    prompt = np.random.default_rng(2).integers(0, tc.vocab, P).astype(np.int32)
    jst = _j_state(jc, rows, True)
    tst = engine_mod.fresh_chunk_state(tc, rows, chunk, "cpu")
    n_chunks = 0
    for lo in range(0, P, chunk):
        n = min(chunk, P - lo)
        buf = np.zeros((1, chunk), np.int32)
        buf[0, :n] = prompt[lo:lo + n]
        jl, jst = jlm.prefill(jp, jnp.asarray(buf), jst, jc, valid_len=jnp.int32(n),
                              chunk_start=jnp.int32(lo))
        with torch.no_grad():
            tl, tst = lm.prefill(tp, torch.from_numpy(buf), tst, tc, valid_len=torch.tensor(n),
                                 chunk_start=torch.tensor(lo))
        _close(tl, jl)
        n_chunks += 1
    assert n_chunks == -(-P // chunk) >= 2
    _compare_states(tc, tst, jst, rows=P)
    # the engine's helper runs the same chunks back to back
    hl, _ = engine_mod.prefill_prompt(tp, tc, tuple(prompt.tolist()), rows, chunk, "cpu")
    assert torch.equal(hl, tl)


@pytest.mark.parametrize("bits", [16, 8])
def test_decode_page_table_matches_reference(bits, pallas_alias):
    """One decode step of two slots over a paged pool (qwen2-72b smoke):
    logits and the pool's pages against the reference's
    decode_step(page_table=)."""
    over = dict(compute_dtype="float32", kv_cache_bits=bits)
    jc = dataclasses.replace(jget_smoke("qwen2-72b", "kernel-q3"), **over)
    tc = dataclasses.replace(get_smoke_config("qwen2-72b", "kernel-q3"), **over)
    _, _, jp, tp = setup("qwen2-72b")
    from repro.models.kv_pool import SlotStatePool as JPool
    from repro_torch.models.kv_pool import SlotStatePool
    jpool, tpool = JPool(jc, 2, 32, page_size=8), SlotStatePool(tc, 2, 32, page_size=8, device="cpu")
    rng = np.random.default_rng(3)
    for slot, P in ((0, 11), (1, 5)):
        jpool.alloc(slot, 20)
        tpool.alloc(slot, 20)
        prompt = rng.integers(0, tc.vocab, (1, P)).astype(np.int32)
        _, jone = jlm.prefill(jp, jnp.asarray(prompt), jlm.init_decode_state(jc, 1, 32), jc)
        jpool.scatter(slot, jone)
        with torch.no_grad():
            _, tone = lm.prefill(tp, torch.from_numpy(prompt), lm.init_decode_state(tc, 1, 32, "cpu"), tc)
        tpool.scatter(slot, tone)
    tok, pos = np.array([[7], [3]], np.int32), np.array([11, 5], np.int32)
    jl, jtree = jlm.decode_step(jp, jpool.tree, jnp.asarray(tok), jnp.asarray(pos), jc,
                                page_table=jpool.page_table)
    with torch.no_grad():
        tl, ttree = lm.decode_step(tp, tpool.tree, torch.from_numpy(tok), torch.from_numpy(pos),
                                   tc, page_table=tpool.page_table)
    _close(tl, jl)
    for g in range(tc.n_groups):
        for name, t in ttree[g]["L0"].items():
            ref = np.asarray(jtree["L0"][name][g])[:-1]          # the trash page aside
            if t.dtype == torch.int8:
                np.testing.assert_array_equal(t[:-1].numpy(), ref, err_msg=name)
            else:
                np.testing.assert_allclose(t[:-1].float().numpy(), ref.astype(np.float32),
                                           rtol=1e-4, atol=1e-5, err_msg=name)


def test_decode_scan_matches_k_decode_steps():
    """K fused micro-steps equal K decode steps, and a row whose ``live``
    goes False keeps its token and position from then on."""
    _, tc, _, tp = setup("qwen2-72b")
    prompts = torch.from_numpy(np.random.default_rng(4).integers(0, tc.vocab, (2, 6)))
    with torch.no_grad():
        _, st = lm.prefill(tp, prompts, lm.init_decode_state(tc, 2, 16, "cpu"), tc)
        copy = [{lk: {k: v.clone() for k, v in layer.items()} for lk, layer in g.items()}
                for g in st]
        tok = torch.tensor([[3], [5]], dtype=torch.int32)
        pos = torch.tensor([6, 6])

        def sample(logits, left):          # row 1 stops after one token
            live = left > 0
            return torch.argmax(logits, -1).to(torch.int32), left - 1, live

        _, tok_k, pos_k, _, toks, live = lm.decode_scan(tp, st, tok, pos, tc,
                                                        torch.tensor([3, 1]), sample, 3)
        t, p = tok, pos
        for j in range(3):
            logits, copy = lm.decode_step(tp, copy, t, p, tc)
            nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
            assert torch.equal(toks[j], nxt)
            keep = torch.tensor([True, j < 1])
            t = torch.where(keep[:, None], nxt[:, None], t)
            p = torch.where(keep, p + 1, p)
    assert live.tolist() == [[True, True], [True, False], [True, False]]
    assert tok_k.tolist() == t.tolist() and pos_k.tolist() == [9, 7]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cpu_decode_rows_independence(arch):
    """What the engine's bit contract rests on, on the CPU's plain path: a
    row's decode logits at capacity 4 do not depend on its slot (bit for
    bit, float32 and bfloat16); against a batch of 1 they are bit-equal in
    bfloat16, and in float32 within F32_TOL only, since the CPU's float32
    products sum a 1-row batch in another order than a 4-row one (about
    1e-6 of logits near 1).  Tokens are held equal either way."""
    for dtype in ("float32", "bfloat16"):
        _, tc, _, tp = setup(arch, dtype)
        prompts = torch.from_numpy(np.random.default_rng(10).integers(0, tc.vocab, (4, 12)))
        toks = torch.arange(3, 7, dtype=torch.int32)[:, None]
        perm = [2, 0, 3, 1]
        with torch.no_grad():
            def decode(rows):
                _, st = lm.prefill(tp, prompts[rows], lm.init_decode_state(tc, len(rows), 32, "cpu"), tc)
                return lm.decode_step(tp, st, toks[rows], torch.full((len(rows),), 12), tc)[0][:, 0]
            d4 = decode([0, 1, 2, 3])
            assert torch.equal(decode(perm), d4[perm])
            for b in range(4):
                d1 = decode([b])
                if dtype == "bfloat16":
                    assert torch.equal(d1, d4[b:b + 1])
                else:
                    _close(d1, d4[b:b + 1].numpy())


# -- the engine against one-shot ------------------------------------------------
# (arch, page size, prefill chunk): pages on and off, chunked and whole
LAYOUTS = [("rwkv6-7b", 0, 64), ("rwkv6-7b", 0, 0), ("qwen2-72b", 16, 16),
           ("qwen2-72b", 0, 16), ("qwen2-72b", 16, 0), (MOE, 16, 16)]


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("arch,page,chunk", LAYOUTS)
def test_engine_matches_one_shot(arch, page, chunk, k, pallas_alias):
    """Greedy tokens equal the reference's one-shot generate and the
    port's; sampled tokens equal the port's one-shot given the request's
    seed.  Three slots for six requests: queueing and slot reuse."""
    eng = _engine(arch, capacity=3, page_size=page, prefill_chunk=chunk, decode_block=k)
    reqs = _requests(arch)
    got = _serve(eng, reqs)
    st = eng.stats
    assert st["completed"] == st["admitted"] == len(reqs) and st["slot_reuses"] == 3
    assert (st["prefill_chunks"] > 0) == bool(eng.chunk) == (bool(chunk) and arch != MOE)
    assert st["pages_total"] == (9 if page else 0) and st["pages_used"] == 0
    for i, req in enumerate(reqs):
        assert len(got[i]) == req.max_new_tokens
        assert got[i] == _port_one_shot(eng, req), i
        if req.temperature == 0:
            assert got[i] == _reference_one_shot(arch, req, eng.seq_len), i


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_arrival_order_and_k_invariant(arch):
    """bfloat16 (the configs' dtype): any arrival order, any K, any slot
    give each request the same tokens, bit for bit."""
    reqs = _requests(arch, seed=5)
    runs = [_serve(_engine(arch, "bfloat16", capacity=2, decode_block=k), reqs, order)
            for k, order in ((1, [0, 1, 2, 3, 4, 5]), (4, [5, 3, 1, 0, 2, 4]),
                             (2, [2, 0, 4, 5, 1, 3]))]
    assert runs[0] == runs[1] == runs[2]
    eng = _engine(arch, "bfloat16", capacity=2)
    assert all(runs[0][i] == _port_one_shot(eng, r) for i, r in enumerate(reqs)
               if r.temperature > 0)


def test_midscan_termination_matches_k1():
    """A slot whose stop fires at micro-step j < K (K forced past its
    remaining tokens) emits exactly max_new_tokens, as at K = 1, frees its
    pages at the retire of the macro-step that finished it, and its
    position never passes its page reservation."""
    reqs = _requests("qwen2-72b", seed=6)
    reqs = [dataclasses.replace(reqs[0], max_new_tokens=3),
            dataclasses.replace(reqs[4], max_new_tokens=10)]
    ref = _serve(_engine("qwen2-72b", capacity=2, page_size=8), reqs)
    eng = _engine("qwen2-72b", capacity=2, page_size=8, decode_block=4)
    eng._pick_k = lambda: 4
    handles = [eng.submit(r) for r in reqs]
    short = eng._pool.pages_needed(len(reqs[0].prompt) + reqs[0].max_new_tokens)
    while not handles[0].done():
        free_before = eng._pool.pages_free
        emitted = eng.step()
        for slot, rec in eng._active.items():
            assert eng._pos[slot] <= len(rec.request.prompt) + rec.request.max_new_tokens - 1
        if handles[0].done():
            assert eng._pool.pages_free == free_before + short and emitted > 0
    eng.drain()
    assert [h.result().tokens for h in handles] == [ref[0], ref[1]]
    assert len(handles[0].result().tokens) == 3


def test_pipeline_dispatch_then_retire():
    """Admission alone never dispatches; the first tick dispatches, the next
    retires K tokens while the following macro-step is queued."""
    eng = _engine("rwkv6-7b", capacity=1, decode_block=4)
    h = eng.submit(_requests("rwkv6-7b")[3])           # 9 new tokens
    assert eng._inflight is None
    assert eng.step() == 0 and eng._inflight is not None and not h.done()
    assert eng.step() == 4 and eng.step() == 4
    assert eng.drain() and h.done() and len(h.result().tokens) == 9
    assert eng.stats["decode_steps"] == 2 and eng.stats["decode_micro_steps"] == 8


# -- the scheduler -----------------------------------------------------------------
def test_slot_reuse_mid_flight():
    eng = _engine("rwkv6-7b", capacity=2)
    rng = np.random.default_rng(4)
    reqs = [Request(prompt=tuple(rng.integers(0, 192, 5).tolist()), max_new_tokens=2 + i)
            for i in range(5)]
    handles = [eng.submit(r) for r in reqs]
    assert eng.n_active == 2 and eng.n_pending == 3
    comps = eng.drain()
    assert eng.stats["completed"] == 5 and eng.stats["slot_reuses"] == 3
    assert eng.stats["slot_hwm"] == 2
    for req, h, c in zip(reqs, handles, comps):
        assert h.done() and h.result() is c and len(c.tokens) == req.max_new_tokens
        assert isinstance(c, Completion) and c.ttft_s > 0 and c.latency_s >= c.ttft_s


def test_bucketed_prefill_bounds_traces():
    """Prompt lengths pad to power-of-two buckets: the prefill shapes are
    counted by bucket, not by length; decode by K."""
    eng = _engine("rwkv6-7b", capacity=4, max_len=40, prefill_chunk=0, decode_block=2)
    rng = np.random.default_rng(5)
    for P in (5, 6, 8):                        # all bucket 8
        eng.submit(Request(prompt=tuple(rng.integers(0, 192, P).tolist()), max_new_tokens=3))
    eng.drain()
    assert eng.stats["prefill_traces"] == 1
    assert eng.stats["decode_traces"] == 1     # K = 2 only
    for P in (9, 16, 4, 7):                    # bucket 16 is the only new one
        eng.submit(Request(prompt=tuple(rng.integers(0, 192, P).tolist()), max_new_tokens=4))
    eng.drain()                                # K = 2, then K = 1
    assert eng.stats["prefill_traces"] == 2 and eng.stats["decode_traces"] == 2
    assert [engine_mod.bucket_len(P, 32) for P in (1, 2, 5, 9, 30, 40)] == [8, 8, 8, 16, 32, 32]


def test_single_token_request_completes_at_admission():
    eng = _engine("rwkv6-7b", capacity=1)
    req = dataclasses.replace(_requests("rwkv6-7b")[0], max_new_tokens=1)
    h = eng.submit(req)
    assert h.done() and eng.stats["decode_steps"] == 0
    assert h.result().tokens == _port_one_shot(eng, req)


def test_submit_validation():
    cfg = get_smoke_config("qwen2-72b")
    eng = EpimEngine(cfg, None, capacity=1, max_len=64, page_size=16, kv_pages=2,
                     device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(prompt=()))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(prompt=(1, 2), max_new_tokens=0))
    with pytest.raises(ValueError, match="outside the vocabulary"):
        eng.submit(Request(prompt=(cfg.vocab,), max_new_tokens=2))
    with pytest.raises(ValueError, match="max_len budget"):
        eng.submit(Request(prompt=(1,) * 70, max_new_tokens=2))
    with pytest.raises(ValueError, match="exceeds the engine's max_len"):
        eng.submit(Request(prompt=(1,) * 60, max_new_tokens=8))
    # 30 + 10 tokens fit max_len but need 3 pages of a 2-page pool
    with pytest.raises(ValueError, match="could never be admitted"):
        eng.submit(Request(prompt=(1,) * 30, max_new_tokens=10))
    with pytest.raises(RuntimeError, match="not finished"):
        RequestHandle(engine_mod._Record(0, Request(prompt=(1,)), 0.0)).result()
    for bad in (dict(capacity=0), dict(decode_block=0)):
        with pytest.raises(ValueError, match=next(iter(bad))):
            EpimEngine(cfg, None, max_len=16, device="cpu", **bad)


def test_oversubscribed_pool_defers_then_completes(pallas_alias):
    """kv_pages below capacity x pages per slot: admission defers while the
    pool is dry, freed pages are reused, and tokens stay those of one-shot."""
    eng = _engine("qwen2-72b", capacity=3, kv_pages=4, prefill_chunk=0)
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=tuple(rng.integers(0, 192, 20).tolist()), max_new_tokens=8, seed=i)
            for i in range(3)]
    handles = [eng.submit(r) for r in reqs]
    # each pins ceil(28 / 16) = 2 pages: 2 of the 3 slots admit
    assert eng.n_active == 2 and eng.n_pending == 1 and eng.stats["queue_depth"] == 1
    comps = eng.drain()
    st = eng.stats
    assert len(comps) == 3 and st["pages_hwm"] <= 4 and st["page_reuses"] >= 2
    assert comps[2].queue_wait_s > 0
    assert st["pages_used"] == 0 and np.all(eng._pool._table == eng._pool.page.trash)
    for req, h in zip(reqs, handles):
        assert h.result().tokens == _port_one_shot(eng, req)
        assert h.result().tokens == _reference_one_shot("qwen2-72b", req, eng.seq_len)


def test_chunked_prefill_respects_recurrence_alignment():
    """rwkv6-7b rounds a 16-token chunk up to its 64-token window; a
    70-token prompt then takes two chunks and keeps one-shot's tokens."""
    eng = _engine("rwkv6-7b", capacity=1, prefill_chunk=16)
    assert eng.chunk == 64
    req = _requests("rwkv6-7b")[5]               # 66 tokens, sampled
    h = eng.submit(req)
    eng.drain()
    assert eng.stats["prefill_chunks"] == 2 and eng.stats["prefill_traces"] == 1
    assert h.result().tokens == _port_one_shot(eng, req)
    assert _engine("qwen2-72b", prefill_chunk=16).chunk == 16     # attention only: 1


def test_moe_arch_prefills_exact_length(pallas_alias):
    """A MoE architecture never buckets (tests/test_engine.py:302) nor
    chunks (tests/test_paged_pool.py:192): a 5-token prompt prefills at L
    = 5 and a 35-token one whole, whatever prefill_chunk says, and both
    keep the reference's one-shot tokens; rwkv6-7b still buckets."""
    eng = _engine(MOE, capacity=2, prefill_chunk=16)
    assert not eng.bucket_prompts and eng.chunk == 0
    assert [engine_mod.prefill_len(eng.cfg, P, 48) for P in (1, 5, 9, 35)] == [1, 5, 9, 35]
    reqs = [_requests(MOE)[i] for i in (0, 2)]            # 6 and 35 tokens
    reqs[0] = dataclasses.replace(reqs[0], prompt=reqs[0].prompt[:5])
    got = _serve(eng, reqs)
    assert eng._prefill_shapes == {("bucket", 5), ("bucket", 35)}
    assert eng.stats["prefill_chunks"] == 0 and eng.stats["prefill_traces"] == 2
    for i, req in enumerate(reqs):
        assert got[i] == _reference_one_shot(MOE, req, eng.seq_len), i
    rwkv = _engine("rwkv6-7b", capacity=1)
    assert rwkv.bucket_prompts and [engine_mod.prefill_len(rwkv.cfg, P, 32)
                                    for P in (2, 5, 9, 30)] == [8, 8, 16, 32]


def test_chunking_off_for_int8_kv():
    """An int8 KV cache prefills whole prompts: a second chunk would attend
    dequantized rows the one-shot path attends fresh."""
    cfg8 = dataclasses.replace(get_smoke_config("qwen2-72b"), kv_cache_bits=8)
    assert EpimEngine(cfg8, None, capacity=1, max_len=32, prefill_chunk=8, device="cpu").chunk == 0


def test_int8_kv_engine_matches_one_shot():
    """At kv_cache_bits=8, paged: the pool pages int8 codes and fp16 scales."""
    _, tc, _, tp = setup("qwen2-72b")
    tc8 = dataclasses.replace(tc, kv_cache_bits=8)
    eng = EpimEngine(tc8, tp, capacity=2, max_len=48, page_size=16, device="cpu")
    assert eng.chunk == 0
    assert {n for n in eng._pool.tree[0]["L0"]} == {"k", "v", "k_s", "v_s"}
    reqs = _requests("qwen2-72b", seed=7)[:3]
    got = _serve(eng, reqs)
    for i, req in enumerate(reqs):
        assert got[i] == _port_one_shot(eng, req)


def test_per_engine_stats():
    """Two engines count their own prefill shapes and steps."""
    a, b = _engine("rwkv6-7b", capacity=1), _engine("rwkv6-7b", capacity=1)
    reqs = _requests("rwkv6-7b", seed=8)
    _serve(a, reqs[:1])
    assert a.stats["prefill_traces"] == 1 and a.stats["decode_steps"] == 5
    _serve(b, reqs[:2])
    assert b.stats["prefill_traces"] == 2 and b.stats["completed"] == 2
    assert a.stats["prefill_traces"] == 1 and a.stats["completed"] == 1
    keys = {"slot_reuses", "decode_steps", "decode_micro_steps", "decode_traces", "completed",
            "admitted", "prefill_traces", "prefill_chunks", "queue_depth", "slot_hwm",
            "pages_total", "pages_used", "pages_free", "pages_hwm", "page_reuses"}
    assert set(a.stats) == keys


def test_uploads_are_copies(monkeypatch):
    """Every host array the queued decode reads is a copy: changing the
    host mirrors (positions, the page table) after a dispatch touches
    neither what the dispatch was given nor the tokens it retires."""
    seen = []
    scan = lm.decode_scan

    def spy(params, state, tok, pos, cfg, aux, sample, k, page_table=None):
        seen.append((pos, aux[0], page_table, pos.clone(), aux[0].clone(), page_table.clone()))
        return scan(params, state, tok, pos, cfg, aux, sample, k, page_table=page_table)

    reqs = _requests("qwen2-72b", seed=9)[:2]
    ref = _serve(_engine("qwen2-72b", capacity=2, decode_block=2), reqs)
    monkeypatch.setattr(engine_mod.lm, "decode_scan", spy)
    eng = _engine("qwen2-72b", capacity=2, decode_block=2)
    handles = [eng.submit(r) for r in reqs]
    while eng._pending or eng._active or eng._prefilling or eng._inflight:
        eng.step()
        if seen and eng._inflight is not None:
            eng._pos += 1000                         # mutate after the dispatch ...
            eng._pool._table[:] = 0
            pos, left, table, pos0, left0, table0 = seen[-1]
            assert torch.equal(pos, pos0) and torch.equal(left, left0)   # ... not seen
            assert torch.equal(table, table0)
            eng._pos -= 1000
            eng._pool._table[:] = table0.numpy()
    assert seen and [h.result().tokens for h in handles] == [ref[0], ref[1]]


# -- setup and the CLIs ------------------------------------------------------------
def test_engine_config_build(tmp_path):
    eng = EngineConfig(arch="rwkv6-7b", epitome="kernel-q3", smoke=True, capacity=1,
                       max_len=32, device="cpu").build()
    assert lm.needs_prepack(eng.cfg) and "Eq" in eng.serve_params["groups"][0]["L0"]["mixer"]["wr"]
    assert eng.config.capacity == 1 and eng.device == torch.device("cpu")
    cfg, params = serve.build_model("rwkv6-7b", "kernel-q3", True, 0, "cpu")
    assert torch.equal(params["embed"], eng.serve_params["embed"])   # build_model's draw
    # a mesh larger than the world (one rank here) is clamped, with a warning
    from repro_torch.launch.mesh import destroy_world
    try:
        with pytest.warns(UserWarning, match="clamped"):
            sharded = EngineConfig(smoke=True, mesh="2,4", device="cpu").build()
        assert dict(zip(sharded.mesh.mesh_dim_names, sharded.mesh.shape)) == \
            {"data": 1, "model": 1}
    finally:
        destroy_world()
    assert EngineConfig(smoke=True, device="cpu").build().mesh is None
    from repro_torch.pim import plan as tplan
    path = str(tmp_path / "plan.json")
    tplan.auto_plan("rwkv6-7b-smoke", weight_bits=3).save(path)
    planned = EngineConfig(arch="rwkv6-7b", plan=path, smoke=True, capacity=1, max_len=32,
                           device="cpu").build()
    assert dict(planned.cfg.layer_config) == dict(tplan.EpitomePlan.load(path).layer_configs())


@pytest.mark.parametrize("arch,extra", [
    ("qwen2-72b", ["--page-size", "16", "--kv-pages", "6", "--prefill-chunk", "16",
                   "--decode-block", "4"]),
    ("rwkv6-7b", ["--page-size", "0", "--prefill-chunk", "64", "--decode-block", "2"]),
    (MOE, ["--page-size", "16", "--prefill-chunk", "16", "--decode-block", "4"])])
def test_serve_cli_engine(arch, extra, capsys):
    toks = serve.main(["--arch", arch, "--smoke", "--epitome", "kernel-q3", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "70" if arch == "rwkv6-7b" else "20",
                       "--max-new-tokens", "5", "--engine"] + extra)
    out = capsys.readouterr().out
    assert tuple(toks.shape) == (3, 5)
    line = next(l for l in out.splitlines() if l.startswith("[serve] engine:"))
    assert "completed=3" in line and "bit_identical=True" in line and "p50_ttft=" in line
    assert "prefill_chunks=" in line and "pages_hwm=" in line and "micro_steps=" in line
    if arch == MOE:                        # whole prompts, never chunked
        assert "prefill_chunks=0" in line


def test_plan_run_decode_block_on_lm_plan(tmp_path, capsys):
    """``plan run --decode-block 4`` on an LM plan serves through the engine
    and requires its greedy tokens to equal the one-shot generate's."""
    from repro_torch.pim import plan as tplan
    path = str(tmp_path / "lm_plan.json")
    tplan.auto_plan("rwkv6-7b-smoke", weight_bits=3).save(path)     # born legal
    plan_cli.main(["run", "--plan", path, "--device", "cpu", "--iters", "1",
                   "--decode-block", "4"])
    out = capsys.readouterr().out
    assert "[plan] engine decode_block=4:" in out and "bit_identical=True" in out
