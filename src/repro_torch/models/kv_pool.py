"""Block-paged KV pool and pooled decode state: the serving engine's state
layer (counterpart of ``repro.models.kv_pool``).

``SlotStatePool`` holds the continuous-batching engine's decode state for a
fixed number of request *slots*, in the port's layout: one dict per group
(``models.lm``), each leaf with the slot on axis 0.  Two kinds of leaves
live behind one interface:

dense per-slot rows
    Recurrent state (RWKV ``x_prev``/``s``/``ffn_x_prev``) is one row per
    slot whatever the sequence length, and so are the attention caches when
    paging is off: (capacity, max_len, Hkv, hd).

block-paged KV
    Attention K/V (and the int8 cache's scales) are one pool of
    ``num_pages`` pages of ``page_size`` tokens, (num_pages + 1, page_size,
    Hkv, hd), plus a per-slot *page table* mapping the slot's logical pages
    to physical ones: the layout ``attention.decode_attention(page_table=)``
    reads.  A slot pins ceil(tokens / page_size) pages instead of a dense
    ``max_len`` block, so the pool may be sized below ``capacity *
    max_len`` and admission defers while no pages are free.  The table
    lives on the host (numpy, changed at admission and free only); the
    decode reads a device copy of it.

One more physical page, the *trash page* (index ``num_pages``), backs every
unmapped table entry: idle and freed slots write their garbage there, and
their reads of it are masked by attention.  Writes through a table go in
place (``index_copy_``), so duplicate indices can only land on the trash
page.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from .blocks import init_group_state
from .config import LayerKind, ModelConfig

_ATTN_KINDS = (LayerKind.ATTN.value, LayerKind.ATTN_LOCAL.value)
_KV_LEAVES = ("k", "v", "k_s", "v_s")

State = List[Dict[str, Dict[str, torch.Tensor]]]   # one dict per group


def paged_leaf_paths(cfg: ModelConfig) -> frozenset:
    """The leaf paths ("L{i}/k", ...) of a group's state that hold
    sequence-indexed KV and so page; every other leaf is a dense row."""
    paths = set()
    for i, (kind, _) in enumerate(cfg.full_pattern):
        if kind in _ATTN_KINDS:
            paths.update(f"L{i}/{leaf}" for leaf in _KV_LEAVES)
    return frozenset(paths)


@dataclasses.dataclass(frozen=True)
class PageSpec:
    """Static geometry of the paged half of the pool."""
    page_size: int          # tokens per page
    pages_per_slot: int     # logical pages in one slot's table row
    num_pages: int          # physical pages (the trash page is extra)

    @property
    def seq_len(self) -> int:
        """KV rows a fully mapped slot addresses (>= the engine's max_len)."""
        return self.pages_per_slot * self.page_size

    @property
    def trash(self) -> int:
        """Physical index of the page unmapped entries point at."""
        return self.num_pages


def _leaves(state: State):
    for g, group in enumerate(state):
        for lk, layer in group.items():
            for name, t in layer.items():
                yield g, lk, name, f"{lk}/{name}", t


def scatter_slot(pool: State, one: State, slot: int, table_row: Optional[torch.Tensor],
                 *, paged_paths: frozenset) -> None:
    """Write a batch-1 state into the pool in place: dense leaves at row
    ``slot``, paged leaves page by page through ``table_row`` (the slot's
    (pages per slot,) device row, unmapped entries at the trash page).  KV
    leaves of ``one`` may hold more rows than the pool (a chunked
    prefill's whole chunks): the pool's rows are taken."""
    for g, lk, name, path, p in _leaves(pool):
        o = one[g][lk][name][0]
        if path in paged_paths:
            page = p.shape[1]
            rows = o[:table_row.numel() * page].reshape((-1, page) + p.shape[2:])
            p.index_copy_(0, table_row, rows.to(p.dtype))
        else:       # a no-op slice for the recurrent rows, the pool's rows for KV
            p[slot].copy_(o[:p.shape[1]])


def gather_slot(pool: State, slot: int, table_row: Optional[torch.Tensor],
                *, paged_paths: frozenset) -> State:
    """Read one slot back out as a batch-1 state (the mirror of
    ``scatter_slot``; for checks and preemption)."""
    out: State = [{lk: {} for lk in group} for group in pool]
    for g, lk, name, path, p in _leaves(pool):
        if path in paged_paths:
            out[g][lk][name] = p[table_row].reshape((1, -1) + p.shape[2:])
        else:
            out[g][lk][name] = p[slot:slot + 1].clone()
    return out


class SlotStatePool:
    """Pooled decode state for ``capacity`` slots, block-paged KV included.

    ``page_size=0`` (or an attention-free arch) gives the dense geometry:
    every leaf a per-slot row, no page accounting, ``page_table`` None.
    ``kv_pages=0`` sizes the pool to exactly ``capacity * pages_per_slot``;
    fewer pages oversubscribe it, and the engine then defers admissions
    while ``can_admit`` says the pool is dry.
    """

    def __init__(self, cfg: ModelConfig, capacity: int, max_len: int,
                 page_size: int = 0, kv_pages: int = 0, device="cuda"):
        self.cfg, self.capacity, self.max_len = cfg, capacity, max_len
        self.device = torch.device(device)
        has_attn = any(kind in _ATTN_KINDS for kind, _ in cfg.full_pattern)
        self.paged_paths = paged_leaf_paths(cfg) if (page_size and has_attn) \
            else frozenset()
        if self.paged_paths:
            pps = -(-max_len // page_size)
            self.page: Optional[PageSpec] = PageSpec(page_size, pps, kv_pages or capacity * pps)
        else:
            self.page = None
        self.seq_len = self.page.seq_len if self.page else max_len
        self.tree = self._init_tree()
        # host-side page accounting (changed at admission and free only)
        if self.page:
            self._table = np.full((capacity, self.page.pages_per_slot),
                                  self.page.trash, np.int32)
            self._free_pages: List[int] = list(range(self.page.num_pages))[::-1]
            self._slot_pages: Dict[int, List[int]] = {}
            self._ever_used: Set[int] = set()
            self._pages_hwm = 0
            self._page_reuses = 0
        else:
            self._table = None
        self._table_dev: Optional[torch.Tensor] = None

    def _init_tree(self) -> State:
        shapes = init_group_state(self.cfg, self.capacity, self.seq_len, "meta")
        out: State = []
        for _ in range(self.cfg.n_groups):
            group: Dict[str, Dict[str, torch.Tensor]] = {}
            for lk, layer in shapes.items():
                group[lk] = {}
                for name, t in layer.items():
                    shp = tuple(t.shape)
                    if f"{lk}/{name}" in self.paged_paths:
                        # (C, seq_len, Hkv, w) -> (pages + trash, page_size, Hkv, w)
                        shp = (self.page.num_pages + 1, self.page.page_size) + shp[2:]
                    group[lk][name] = torch.zeros(shp, dtype=t.dtype, device=self.device)
            out.append(group)
        return out

    # -- page accounting ----------------------------------------------------
    @property
    def paged(self) -> bool:
        return self.page is not None

    def pages_needed(self, tokens: int) -> int:
        """Pages a request holding ``tokens`` KV rows pins for its life."""
        if not self.page:
            return 0
        return -(-tokens // self.page.page_size)

    def can_admit(self, tokens: int) -> bool:
        return (not self.page
                or self.pages_needed(tokens) <= len(self._free_pages))

    def alloc(self, slot: int, tokens: int) -> None:
        """Reserve and map every page the request will ever need (prompt +
        max_new_tokens), so decode crosses page boundaries with no host
        work and never starves mid-flight."""
        if not self.page:
            return
        n = self.pages_needed(tokens)
        if n > len(self._free_pages):
            raise RuntimeError(
                f"KV pool dry: slot {slot} needs {n} pages, "
                f"{len(self._free_pages)} free (admission should defer)")
        pages = [self._free_pages.pop() for _ in range(n)]
        self._page_reuses += sum(p in self._ever_used for p in pages)
        self._ever_used.update(pages)
        self._slot_pages[slot] = pages
        self._table[slot] = self.page.trash
        self._table[slot, :n] = pages
        self._table_dev = None            # the host table changed: upload anew
        self._pages_hwm = max(self._pages_hwm, self.pages_used)

    def free(self, slot: int) -> None:
        if not self.page:
            return
        for p in reversed(self._slot_pages.pop(slot, [])):
            self._free_pages.append(p)
        self._table[slot] = self.page.trash
        self._table_dev = None

    @property
    def pages_used(self) -> int:
        return self.page.num_pages - len(self._free_pages) if self.page else 0

    @property
    def pages_free(self) -> int:
        return len(self._free_pages) if self.page else 0

    def stats(self) -> Dict[str, int]:
        if not self.page:
            return {"pages_total": 0, "pages_used": 0, "pages_free": 0,
                    "pages_hwm": 0, "page_reuses": 0}
        return {"pages_total": self.page.num_pages,
                "pages_used": self.pages_used,
                "pages_free": self.pages_free,
                "pages_hwm": self._pages_hwm,
                "page_reuses": self._page_reuses}

    # -- device ops ----------------------------------------------------------
    @property
    def page_table(self) -> Optional[torch.Tensor]:
        """The (capacity, pages_per_slot) int32 device table the decode
        reads; None for a dense pool.  A copy of the host table, made again
        after each admission or free: queued work never reads a host
        buffer the pool goes on changing."""
        if self._table is None:
            return None
        if self._table_dev is None:
            self._table_dev = torch.tensor(self._table, device=self.device)
        return self._table_dev

    def table_row(self, slot: int) -> Optional[torch.Tensor]:
        """A device copy of one slot's table row (None for a dense pool)."""
        if self._table is None:
            return None
        return torch.tensor(self._table[slot], dtype=torch.long, device=self.device)

    def scatter(self, slot: int, one: State) -> None:
        """Write a finished prefill's batch-1 state into ``slot``."""
        scatter_slot(self.tree, one, slot, self.table_row(slot),
                     paged_paths=self.paged_paths)

    def gather(self, slot: int) -> State:
        return gather_slot(self.tree, slot, self.table_row(slot),
                           paged_paths=self.paged_paths)
