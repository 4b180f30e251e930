"""Port parity: ``repro_torch.models.attention`` and RoPE against the JAX
reference's ``repro.models.attention`` and ``common.apply_rope``, function
by function, on inputs drawn by numpy from a seed.

Tolerances: float32 results within 1e-5 (relative and absolute) of the
reference's, which sums the same float32 terms in another order (scores of
16-32 terms, outputs of O(1)); the decode path also runs the projections
(dense float32 weights), within 1e-5 too.  Integer artifacts (int8 KV
codes) are equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import common

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(tree):
    return {k: _tree(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_matches_reference(batched, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 5000, (2, 7)) if batched else np.arange(7) + 30).astype(np.int32)
    tx = _t(x).to(getattr(torch, dtype))
    a = common.apply_rope(tx, _t(pos), 10000.0)
    b = jcommon.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos), 10000.0)
    assert a.dtype == tx.dtype and a.shape == tx.shape
    # angles up to 5000 rad: sin/cos of the same float32 angle in two libraries
    tol = dict(rtol=1e-5, atol=2e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(a), _np(b), **tol)
    np.testing.assert_allclose(common.rope_freqs(16, 10000.0).numpy(),
                               np.asarray(jcommon.rope_freqs(16, 10000.0)), rtol=1e-6)


# (B, Sq, Skv, H, Hkv, hd, q_offset, kv_chunk, causal, window, cap)
CHUNK_CASES = [
    (2, 9, 9, 4, 2, 16, 0, 4, True, None, 0.0),       # GQA, 3 chunks, ragged last
    (1, 13, 13, 4, 1, 8, 0, 5, True, 4, 50.0),        # window + softcap, multi-chunk
    (2, 5, 17, 2, 2, 16, 12, 6, True, 3, 0.0),        # offset queries (chunked prefill)
    (1, 6, 6, 4, 4, 8, 0, 6, False, None, 30.0),      # one chunk, not causal
]


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_attn_matches_reference(case):
    B, Sq, Skv, H, Hkv, hd, off, chunk, causal, window, cap = case
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    # large scores so the softcap and the online rescale both bite
    a = tattn._chunk_attn(_t(q) * 3, _t(k), _t(v), off, chunk, causal, window, cap)
    b = jattn._chunk_attn(jnp.asarray(q) * 3, jnp.asarray(k), jnp.asarray(v), off, chunk,
                          causal, window, cap)
    assert a.shape == (B, Sq, H, hd) and torch.isfinite(a).all()
    np.testing.assert_allclose(_np(a), _np(b), **F32)


def test_chunk_attn_reads_kv_head_h_over_g():
    """GQA: query head h reads KV head h // G (repeat_interleave): with one
    KV head's values set apart, only its G query heads see them."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 4, 6, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 4, 3, 8)).astype(np.float32))
    v = torch.zeros((1, 4, 3, 8))
    v[:, :, 1] = 1.0
    o = tattn._chunk_attn(q, k, v, 0, 4, True, None, 0.0)
    torch.testing.assert_close(o[:, :, 2:4], torch.ones((1, 4, 2, 8)))
    assert float(o[:, :, :2].abs().max()) == 0.0 and float(o[:, :, 4:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_codes_equal(dtype):
    rng = np.random.default_rng(3)
    t = (rng.standard_normal((2, 5, 3, 16)) * rng.uniform(0.01, 10, (2, 5, 3, 1))).astype(np.float32)
    t[0, 0, 0] = 0.0                                    # an all-zero row: scale 1e-8
    q, s = tattn.quantize_kv(_t(t).to(getattr(torch, dtype)))
    jq, js = jattn.quantize_kv(jnp.asarray(t, dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.float16 and s.shape == (2, 5, 3, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tattn.dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(jattn.dequantize_kv(jq, js, jnp.float32)))


def _cfgs(arch="gemma2-2b", bits=16, **over):
    """The smoke config of ``arch`` (dense weights, float32), at
    kv_cache_bits ``bits``, for both packages."""
    over = dict(compute_dtype="float32", kv_cache_bits=bits, **over)
    return (dataclasses.replace(jget_smoke(arch, "off"), **over),
            dataclasses.replace(get_smoke_config(arch, "off"), **over))


def _attn_params(jc, seed=4):
    """One attention layer's parameters, biases drawn non-zero."""
    tree = jax.tree.map(np.asarray, jattn.init_attn(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    for w in tree.values():
        if "b" in w:
            w["b"] = (0.1 * rng.standard_normal(w["b"].shape)).astype(np.float32)
    return tree


def _filled_cache(jc, B, Smax, rng):
    """A cache whose rows hold earlier tokens' K/V (int8 codes and scales
    at kv_cache_bits=8), the same for both packages."""
    c = jax.tree.map(lambda a: np.array(a[0]), jattn.init_kv_cache(jc, jattn.CacheSpec(Smax, B)))
    for name, a in c.items():
        if a.dtype == np.int8:
            c[name] = rng.integers(-127, 128, a.shape).astype(np.int8)
        elif name.endswith("_s"):
            c[name] = rng.uniform(0.001, 0.02, a.shape).astype(a.dtype)
        else:
            c[name] = rng.standard_normal(a.shape).astype(a.dtype)
    return c


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches_reference(per_row, bits, local):
    """One decode step at a scalar or a per-row position, float or int8
    cache, global or sliding-window (window 8, positions past it): output
    and every cache row match, int8 codes equal."""
    jc, tc = _cfgs("qwen2-72b" if not local else "gemma2-2b", bits)
    tree = _attn_params(jc)
    rng = np.random.default_rng(5)
    B, Smax = 3, 24
    cache = _filled_cache(jc, B, Smax, rng)
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    pos = np.array([11, 17, 3], np.int32) if per_row else np.int32(13)
    jpos = jnp.asarray(pos)
    tpos = _t(pos).long() if per_row else 13
    b, jcache = jattn.decode_attention(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                       jax.tree.map(jnp.asarray, cache), jpos, jc, local=local)
    tcache = _tree(cache)
    a, out_cache = tattn.decode_attention(_tree(tree), _t(x), tcache, tpos, tc, local=local)
    assert out_cache is tcache                          # written in place
    np.testing.assert_allclose(_np(a), _np(b), **F32)
    for name, t in tcache.items():
        ref = np.asarray(jcache[name])
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
        else:
            np.testing.assert_allclose(_np(t), ref.astype(np.float32), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_decode_attention_position_as_a_tensor_changes_nothing():
    jc, tc = _cfgs("gemma2-2b")
    tree = _tree(_attn_params(jc))
    rng = np.random.default_rng(6)
    cache = _filled_cache(jc, 2, 16, rng)
    x = _t(rng.standard_normal((2, 1, jc.d_model)).astype(np.float32))
    outs = [tattn.decode_attention(tree, x, _tree(cache), p, tc, local=True)[0]
            for p in (9, torch.tensor(9), torch.tensor([9, 9]))]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("bits", [16, 8])
def test_decode_attention_page_table_ignores_nan_garbage(bits):
    """Block-paged decode: K/V live in a pool of pages plus a trash page
    that unmapped table entries point at; the trash page and every page no
    slot owns hold NaN.  The output matches the reference's and is finite,
    and the step lands at the page row the table maps."""
    jc, tc = _cfgs("qwen2-72b", bits)
    tree = _attn_params(jc)
    rng = np.random.default_rng(7)
    page, n_pages, B, per_slot = 4, 7, 2, 3            # page 6 is the trash page
    pool = _filled_cache(jc, n_pages, page, rng)       # (pages, page, Hkv, hd)
    table = np.array([[2, 0, 6], [5, 6, 6]], np.int32)  # slot 1 owns one page
    for name, a in pool.items():
        if a.dtype != np.int8:
            a[[1, 3, 4, 6]] = np.nan
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    pos = np.array([6, 2], np.int32)
    b, jpool = jattn.decode_attention(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, pool), jnp.asarray(pos), jc,
                                      page_table=jnp.asarray(table))
    tpool = _tree(pool)
    a, _ = tattn.decode_attention(_tree(tree), _t(x), tpool, _t(pos).long(), tc,
                                  page_table=_t(table))
    assert torch.isfinite(a).all()
    np.testing.assert_allclose(_np(a), _np(b), **F32)
    for name, t in tpool.items():       # NaN pages stay NaN in both
        ref = np.asarray(jpool[name])
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
        else:
            np.testing.assert_allclose(_np(t), ref.astype(np.float32), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    with pytest.raises(ValueError, match="per-row"):
        tattn.decode_attention(_tree(tree), _t(x), tpool, 3, tc, page_table=_t(table))


@pytest.mark.parametrize("local", [False, True])
def test_chunked_prefill_attention_matches_reference(local):
    """A prompt chunk of 5 at row 7 of a running cache (rows before it from
    earlier chunks): output and cache match; the chunk's rows are written
    in place; an int8 cache is refused."""
    jc, tc = _cfgs("gemma2-2b", attn_kv_chunk=6)
    tree = _attn_params(jc)
    rng = np.random.default_rng(8)
    B, C, Smax, start = 2, 5, 20, 7
    cache = _filled_cache(jc, B, Smax, rng)
    for a in cache.values():
        a[:, start:] = 0.0                             # a fresh cache beyond the chunks so far
    x = rng.standard_normal((B, C, jc.d_model)).astype(np.float32)
    b, jcache = jattn.chunked_prefill_attention(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
        jnp.int32(start), jc, local=local)
    tcache = _tree(cache)
    a, _ = tattn.chunked_prefill_attention(_tree(tree), _t(x), tcache, torch.tensor(start),
                                           tc, local=local)
    np.testing.assert_allclose(_np(a), _np(b), **F32)
    for name, t in tcache.items():
        np.testing.assert_allclose(_np(t), np.asarray(jcache[name]), rtol=1e-5, atol=1e-6)
    _, tc8 = _cfgs("gemma2-2b", 8)
    with pytest.raises(NotImplementedError, match="float KV cache"):
        tattn.chunked_prefill_attention(_tree(tree), _t(x), tcache, start, tc8)


@pytest.mark.parametrize("bits", [16, 8])
def test_init_kv_cache_matches_reference(bits):
    jc, tc = _cfgs("qwen2-72b", bits)
    mine = tattn.init_kv_cache(tc, tattn.CacheSpec(max_len=9, batch=2), n=3, device="cpu")
    theirs = jattn.init_kv_cache(jc, jattn.CacheSpec(max_len=9, batch=2), n=3)
    assert set(mine) == set(theirs)
    for name, t in mine.items():
        assert tuple(t.shape) == theirs[name].shape and not t.any()
        assert str(t.dtype).replace("torch.", "") == str(theirs[name].dtype)


def test_attention_prefill_matches_reference_with_return_kv():
    """The full prefill path: projections with biases, RoPE at given (B, S)
    positions, the chunked softmax over 3 chunks with a window, softcap."""
    jc, tc = _cfgs("gemma2-2b", attn_kv_chunk=4)
    tree = _attn_params(jc)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 11, jc.d_model)).astype(np.float32)
    pos = np.stack([np.arange(11), np.arange(11) + 5]).astype(np.int32)
    b, (bk, bv) = jattn.attention(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jc,
                                  local=True, positions=jnp.asarray(pos), return_kv=True)
    a, (ak, av) = tattn.attention(_tree(tree), _t(x), tc, local=True, positions=_t(pos),
                                  return_kv=True)
    for mine, theirs in ((a, b), (ak, bk), (av, bv)):
        np.testing.assert_allclose(_np(mine), _np(theirs), **F32)
