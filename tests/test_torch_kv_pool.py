"""Port parity: the block-paged KV pool (``repro_torch.models.kv_pool``)
against ``repro.models.kv_pool``: page accounting, the page table and the
trash page, the dense pool's accounting, and the pool contents a scatter
leaves, compared with the reference's ``scatter_slot`` leaf by leaf (the
reference stacks the groups on axis 0 of each leaf; the port keeps a list
of per-group dicts with the slot on axis 0)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.models.kv_pool import SlotStatePool as JPool
from repro.models.kv_pool import paged_leaf_paths as j_paged_leaf_paths
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.models.kv_pool import (PageSpec, SlotStatePool, gather_slot,
                                        paged_leaf_paths)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

# phi3.5-moe: attention with the MoE FFN, whose layers carry no state but K/V;
# jamba: Mamba layers (dense conv and h rows) beside one attention layer a
# group (paged K/V)
ARCHS = ("rwkv6-7b", "qwen2-72b", "gemma2-2b", "phi3.5-moe-42b-a6.6b",
         "jamba-1.5-large-398b")


def _pools(arch, capacity, max_len, bits=16, **kw):
    over = dict(compute_dtype="float32", kv_cache_bits=bits)
    jc = dataclasses.replace(jget_smoke(arch), **over)
    tc = dataclasses.replace(get_smoke_config(arch), **over)
    return (jc, JPool(jc, capacity, max_len, **kw),
            tc, SlotStatePool(tc, capacity, max_len, device="cpu", **kw))


def _accounting(pool):
    return (pool.paged, pool.seq_len, pool.stats(), pool.pages_used, pool.pages_free,
            None if pool.page_table is None else np.asarray(pool.page_table).tolist())


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_leaf_paths_and_layout(arch):
    _, jpool, tc, pool = _pools(arch, 2, 40, page_size=16)
    assert paged_leaf_paths(tc) == j_paged_leaf_paths(jpool.cfg)
    assert dataclasses.astuple(pool.page or PageSpec(0, 0, 0)) == \
        dataclasses.astuple(jpool.page or PageSpec(0, 0, 0))
    assert len(pool.tree) == tc.n_groups
    for lk, layer in pool.tree[0].items():
        for name, t in layer.items():
            ref = jpool.tree[lk][name]
            assert tuple(t.shape) == tuple(ref.shape[1:]), f"{lk}/{name}"
            assert str(t.dtype).replace("torch.", "") == str(ref.dtype)
            if f"{lk}/{name}" in pool.paged_paths:      # (pages + trash, page, Hkv, w)
                assert t.shape[:2] == (pool.page.num_pages + 1, 16)


@pytest.mark.parametrize("bits", [16, 8])
def test_page_accounting_matches_reference(bits):
    """The same admissions and frees on both pools: page tables, trash
    entries, dryness, reuse and high-water marks equal step by step."""
    _, jpool, _, pool = _pools("qwen2-72b", 2, 40, bits, page_size=16)
    assert pool.paged and pool.seq_len == 48 and pool.page.pages_per_slot == 3
    assert [pool.pages_needed(t) for t in (1, 16, 17, 48)] == \
        [jpool.pages_needed(t) for t in (1, 16, 17, 48)] == [1, 1, 2, 3]
    ops = [("alloc", 0, 40), ("alloc", 1, 33), ("free", 0), ("alloc", 0, 17),
           ("free", 1), ("alloc", 1, 5), ("free", 0), ("free", 1)]
    for op in ops:
        for p in (jpool, pool):
            getattr(p, op[0])(*op[1:])
        assert _accounting(pool) == _accounting(jpool), op
        assert [pool.can_admit(t) for t in (1, 17, 33, 49)] == \
            [jpool.can_admit(t) for t in (1, 17, 33, 49)]
        if op[0] == "free":
            assert np.all(np.asarray(pool.table_row(op[1])) == pool.page.trash)
    assert pool.stats()["page_reuses"] > 0 and pool.pages_used == 0
    pool.alloc(0, 48)
    pool.alloc(1, 48)
    assert not pool.can_admit(1)
    with pytest.raises(RuntimeError, match="KV pool dry"):
        pool.alloc(0, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_pool_accounting(arch):
    """page_size 0 (and any attention-free arch): every leaf a per-slot
    row, no pages, no table."""
    _, jpool, _, pool = _pools(arch, 2, 40)
    assert not pool.paged and pool.seq_len == 40 and pool.page_table is None
    assert pool.pages_needed(40) == 0 and pool.can_admit(10 ** 9)
    assert _accounting(pool) == _accounting(jpool)
    assert pool.stats() == {"pages_total": 0, "pages_used": 0, "pages_free": 0,
                            "pages_hwm": 0, "page_reuses": 0}
    if arch == "rwkv6-7b":            # no attention: paging asked for, dense given
        assert not SlotStatePool(pool.cfg, 2, 40, page_size=16, device="cpu").paged


def _patterned(jc, tc, rows):
    """The same batch-1 state on both sides, every leaf a distinct pattern."""
    jone = jax.tree.map(
        lambda l: (jnp.arange(l.size) % 251).reshape(l.shape).astype(l.dtype),
        jlm.init_decode_state(jc, 1, rows))
    one = [{lk: {k: torch.from_numpy(np.array(v[g])) for k, v in layer.items()}
            for lk, layer in jone.items()} for g in range(tc.n_groups)]
    return jone, one


@pytest.mark.parametrize("page_size", [16, 0])
@pytest.mark.parametrize("bits", [16, 8])
def test_scatter_gather_match_reference(page_size, bits):
    """A fully mapped slot and a short one: the pool after each scatter
    equals the reference's leaf for leaf (mapped pages; the trash page
    aside), and gather gives the state back (the short slot's mapped rows)."""
    jc, jpool, tc, pool = _pools("qwen2-72b", 2, 48, bits, page_size=page_size)
    jone, one = _patterned(jc, tc, pool.seq_len)
    for slot, tokens in ((0, 48), (1, 20)):
        for p in (jpool, pool):
            p.alloc(slot, tokens)
        jpool.scatter(slot, jone)
        pool.scatter(slot, one)
    for g in range(tc.n_groups):
        for lk, layer in pool.tree[g].items():
            for name, t in layer.items():
                ref = np.asarray(jpool.tree[lk][name][g])
                if f"{lk}/{name}" in pool.paged_paths:
                    t, ref = t[:-1], ref[:-1]          # the trash page's bits are unspecified
                np.testing.assert_array_equal(t.numpy(), ref, err_msg=f"{lk}/{name}")
    mapped = {0: pool.seq_len, 1: 32 if page_size else pool.seq_len}
    for slot, rows in mapped.items():
        back = pool.gather(slot)
        for g in range(tc.n_groups):
            for lk, layer in back[g].items():
                for name, t in layer.items():
                    ref = one[g][lk][name]
                    if name in ("k", "v", "k_s", "v_s"):
                        t, ref = t[:, :rows], ref[:, :rows]
                    assert torch.equal(t, ref), f"slot {slot} {lk}/{name}"


def test_scatter_takes_the_pools_rows_of_a_longer_state():
    """A chunked prefill's state holds whole chunks, more KV rows than the
    pool: scatter takes the pool's rows, dense or paged."""
    for page_size in (0, 16):
        _, _, tc, pool = _pools("qwen2-72b", 1, 40, page_size=page_size)
        one = lm.init_decode_state(tc, 1, 64, "cpu")
        for g in one:
            for layer in g.values():
                for t in layer.values():
                    t.copy_(torch.randn(t.shape))
        pool.alloc(0, 40)
        pool.scatter(0, one)
        back = gather_slot(pool.tree, 0, pool.table_row(0), paged_paths=pool.paged_paths)
        for g in range(tc.n_groups):
            for name, t in back[g]["L0"].items():
                assert torch.equal(t[:, :40], one[g]["L0"][name][:, :40]), name
