"""Continuous-batching serving engine with a request-level API (counterpart
of ``repro.launch.engine``).

    eng = EngineConfig(arch="qwen2-72b", epitome="kernel-q3", capacity=4,
                       max_len=320, page_size=16, kv_pages=48).build()
    handles = [eng.submit(Request(prompt=p, max_new_tokens=32)) for p in prompts]
    completions = eng.drain()          # in submission order

API
---
``Request``
    Frozen per-request spec: ``prompt`` (token ids), ``max_new_tokens``,
    ``temperature`` (0 = greedy), ``seed``.  A sampled request draws from
    its own ``torch.Generator(device).manual_seed(seed)``, with
    ``serve._select`` on its own row, only while it is live: its tokens
    depend on the request alone, never on arrival order, slot, K or paging.
``Completion``
    Frozen result: ``request_id``, ``prompt_len``, ``tokens`` (generated
    ids), ``ttft_s`` (submit -> first token), ``latency_s`` (submit -> last
    token), ``queue_wait_s`` (submit -> admission) and ``token_times`` (a
    ``perf_counter`` stamp per token).
``RequestHandle``
    Returned by ``submit``; ``done()`` / ``result()`` poll the completion.
``EngineConfig``
    Everything needed to stand a server up: ``arch``, ``epitome``,
    ``plan`` (a path or an EpitomePlan), ``smoke``, ``capacity`` (decode
    slots), ``max_len`` (per-request token budget), ``page_size`` /
    ``kv_pages`` (block-paged KV geometry; page size 0 = dense per-slot
    rows), ``prefill_chunk`` (0 = whole-prompt prefill), ``decode_block``
    (decode micro-steps per dispatch), ``seed`` (weights, from
    ``serve.build_model``'s generator) and ``device``.  ``mesh`` is ``''``
    or None: sharding comes with the scale-out slice.  ``build()`` returns
    a ready ``EpimEngine``.
``EpimEngine``
    ``submit`` checks a request (length against ``max_len``, ids against
    the vocabulary, pages against the pool) and admits it when a slot and
    its KV pages are free; ``step()`` runs at most one prefill chunk, the
    admissions, the retire of the decode macro-step in flight and the
    dispatch of the next; ``drain()`` steps until idle and returns every
    completion in submission order.  ``stats`` has the reference's keys:
    ``prefill_traces`` and ``decode_traces`` count the distinct prefill
    shapes (bucket or chunk length) and K values this engine has run, the
    programs a graph cache would hold.

Scheduling
----------
One pooled decode state (``models.kv_pool.SlotStatePool``) of ``capacity``
slots: dense recurrent rows for RWKV, a block-paged KV pool for attention.
Admission reserves every page a request will need (prompt +
max_new_tokens), so decode never starves; when the pool is dry the queue
head defers (FIFO head-of-line) until a completion frees pages.  Decode
runs at the full pool width with per-slot positions; idle slots compute
garbage in their own rows (and write it to the trash page), which per-row
independence and the attention masks keep away from live requests.  A
macro-step fuses K = ``_pick_k()`` micro-steps (``lm.decode_scan``); the
host mirrors of position and remaining tokens advance at dispatch, and the
tokens come back at the next step's retire.  Every host array the queued
work reads (positions, remaining tokens, the page table) is uploaded as a
copy, since the engine goes on changing it.

Prompts up to ``prefill_chunk`` tokens prefill at once, right-padded to a
power-of-two bucket (at least 8, at most the pool's sequence length; the
pads are masked by ``valid_len``).  Longer prompts prefill one chunk per
step, interleaved with decode; the chunk is rounded up to
``ssm.recurrence_alignment`` so chunk boundaries are recurrence-window
boundaries, and the transient chunk state holds attention K/V in float32
as the one-shot prefill attends its fresh K/V (the scatter into the pool
rounds once, where the one-shot path rounds).  An int8 KV cache prefills
whole prompts: a second chunk would attend dequantized rows.  A MoE
architecture prefills every prompt whole and at its exact length, as the
reference's does (its capacity routing couples the tokens of a dispatch,
and pads would take expert-queue ranks).

Where bits agree
----------------
Against the one-shot ``serve.generate`` of one request with the same
``max_len`` (``seq_len`` when paged): the engine prefills at the bucket or
chunk length and decodes at ``capacity`` rows, and its attention reads the
pool's ``seq_len`` rows.  On the CPU the plain kernels give equal greedy
tokens; on the card kernel #1 picks its splits from the row count, so the
logits may differ in the last bits and tokens are held to the one-shot's
by their logit margins.  Within the engine, decode at ``capacity`` rows is
row-independent: K, arrival order and slot change no bit.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import lm
from ..models.kv_pool import SlotStatePool, paged_leaf_paths
from ..models.ssm import recurrence_alignment
from .serve import _select, build_model


# ---------------------------------------------------------------------------
# Request-level API
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``prompt`` is coerced to a tuple of ints;
    ``temperature`` 0 means greedy."""
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "prompt", tuple(int(t) for t in self.prompt))


@dataclasses.dataclass(frozen=True)
class Completion:
    request_id: int
    prompt_len: int
    tokens: Tuple[int, ...]        # generated ids only (prompt excluded)
    ttft_s: float                  # submit -> first token
    latency_s: float               # submit -> last token
    queue_wait_s: float = 0.0      # submit -> admission (slot + pages free)
    token_times: Tuple[float, ...] = ()  # perf_counter stamp per token


class _Record:
    __slots__ = ("rid", "request", "tokens", "submit_t", "first_tok_t",
                 "completion", "slot", "queue_wait", "token_times", "generator")

    def __init__(self, rid: int, request: Request, submit_t: float):
        self.rid, self.request, self.submit_t = rid, request, submit_t
        self.tokens: List[int] = []
        self.first_tok_t = 0.0
        self.completion: Optional[Completion] = None
        self.slot: Optional[int] = None
        self.queue_wait = 0.0
        self.token_times: List[float] = []
        self.generator: Optional[torch.Generator] = None


class RequestHandle:
    """Poll-able view of a submitted request."""

    def __init__(self, record: _Record):
        self._rec = record

    @property
    def request_id(self) -> int:
        return self._rec.rid

    def done(self) -> bool:
        return self._rec.completion is not None

    def result(self) -> Completion:
        if self._rec.completion is None:
            raise RuntimeError(f"request {self._rec.rid} not finished; "
                               "step()/drain() the engine first")
        return self._rec.completion


class _Inflight:
    """A dispatched, not yet retired macro-step: its stacked (k, C) token
    tensor and the host snapshot of which slots emit how many tokens."""
    __slots__ = ("toks", "snapshot", "k")

    def __init__(self, toks, snapshot, k: int):
        self.toks, self.snapshot, self.k = toks, snapshot, k


class _PrefillJob:
    """A chunked prefill in flight: slot and pages reserved, the transient
    batch-1 state grown one chunk per step."""
    __slots__ = ("rec", "state", "done")

    def __init__(self, rec: _Record, state):
        self.rec, self.state, self.done = rec, state, 0


# ---------------------------------------------------------------------------
# Prefill: bucketed and chunked
# ---------------------------------------------------------------------------
def _upload(a, device) -> torch.Tensor:
    """A device copy of host data (never a view of a buffer the engine goes
    on changing)."""
    return torch.tensor(a, device=device)


def bucket_len(P: int, seq_len: int) -> int:
    """Power-of-two prompt bucket, at least 8, capped at ``seq_len``."""
    return min(max(8, 1 << (P - 1).bit_length()), seq_len)


def buckets_prompts(cfg) -> bool:
    """Whether whole prompts pad to a bucket: not for a MoE architecture,
    whose prompts prefill at their exact length and never in chunks."""
    return "moe" not in cfg.ffn_pattern


def prefill_len(cfg, P: int, seq_len: int) -> int:
    """Rows of the whole-prompt prefill of a P-token prompt."""
    return bucket_len(P, seq_len) if buckets_prompts(cfg) else P


def prefill_bucket(params, cfg, prompt: Sequence[int], L: int, seq_len: int, device):
    """One prompt right-padded to L rows into a fresh batch-1 state of
    ``seq_len`` KV rows.  Returns (last real token's logits (1, 1, vocab),
    state)."""
    buf = np.zeros((1, L), np.int64)
    buf[0, :len(prompt)] = prompt
    state = lm.init_decode_state(cfg, 1, seq_len, device)
    with torch.no_grad():
        return lm.prefill(params, _upload(buf, device), state, cfg,
                          valid_len=_upload(len(prompt), device))


def fresh_chunk_state(cfg, seq_len: int, chunk: int, device):
    """Transient batch-1 state of a chunked prefill: KV rows for whole
    chunks (a last chunk may run past ``seq_len``; the scatter into the
    pool takes its rows), held in float32, so chunk j attends chunks < j at
    the precision the one-shot prefill attends its fresh K/V."""
    kv = paged_leaf_paths(cfg)
    rows = -(-seq_len // chunk) * chunk
    return [{lk: {k: (v.float() if f"{lk}/{k}" in kv else v) for k, v in layer.items()}
             for lk, layer in group.items()}
            for group in lm.init_decode_state(cfg, 1, rows, device)]


def prefill_chunk(params, cfg, prompt: Sequence[int], lo: int, chunk: int, state, device):
    """Rows lo .. lo + chunk of a prompt (right-padded) against the carried
    chunk state.  Returns (last real token's logits, state)."""
    n = min(chunk, len(prompt) - lo)
    buf = np.zeros((1, chunk), np.int64)
    buf[0, :n] = prompt[lo:lo + n]
    with torch.no_grad():
        return lm.prefill(params, _upload(buf, device), state, cfg,
                          valid_len=_upload(n, device), chunk_start=_upload(lo, device))


def prefill_prompt(params, cfg, prompt: Sequence[int], seq_len: int, chunk: int, device):
    """The engine's prefill of one prompt, its chunks back to back: (first
    token's logits (1, 1, vocab), batch-1 state).  The engine runs the
    same calls, one chunk a step."""
    if not chunk or len(prompt) <= chunk:
        return prefill_bucket(params, cfg, prompt, prefill_len(cfg, len(prompt), seq_len),
                              seq_len, device)
    state = fresh_chunk_state(cfg, seq_len, chunk, device)
    for lo in range(0, len(prompt), chunk):
        logits, state = prefill_chunk(params, cfg, prompt, lo, chunk, state, device)
    return logits, state


# ---------------------------------------------------------------------------
# EngineConfig: the one setup path
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EngineConfig:
    """Source of truth for standing up a server (the CLI flags mirror these
    fields); see the module docstring."""
    arch: str = "rwkv6-7b"
    epitome: str = "off"
    plan: Any = None                 # path str | EpitomePlan | None
    mesh: Optional[str] = ""         # '' or None: one card
    smoke: bool = False
    capacity: int = 4
    max_len: int = 128
    page_size: int = 16              # KV page tokens; 0 = dense per-slot
    kv_pages: int = 0                # pool pages; 0 = capacity * pages/slot
    prefill_chunk: int = 64          # chunked-prefill tokens; 0 = whole
    decode_block: int = 1            # decode micro-steps fused per dispatch
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "EpimEngine":
        if self.mesh:
            raise NotImplementedError(
                f"mesh {self.mesh!r}: sharded serving comes with the scale-out slice "
                f"of the port (ROADMAP.md item 16); use '' or None")
        plan = self.plan or None
        if isinstance(plan, str):
            from ..pim.plan import EpitomePlan
            plan = EpitomePlan.load(plan)
        cfg, params = build_model(self.arch, self.epitome, self.smoke, self.seed,
                                  self.device, plan=plan)
        engine = EpimEngine(cfg, params, capacity=self.capacity, max_len=self.max_len,
                            page_size=self.page_size, kv_pages=self.kv_pages,
                            prefill_chunk=self.prefill_chunk,
                            decode_block=self.decode_block, device=self.device)
        engine.config = self
        return engine


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
class EpimEngine:
    """Slot-scheduled continuous-batching server over one pooled state."""

    def __init__(self, cfg, serve_params, capacity: int = 4, max_len: int = 128,
                 page_size: int = 16, kv_pages: int = 0, prefill_chunk: int = 64,
                 decode_block: int = 1, device="cuda"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        self.cfg, self.serve_params = cfg, serve_params
        self.capacity, self.max_len = capacity, max_len
        self.device = torch.device(device)
        self._pool = SlotStatePool(cfg, capacity, max_len, page_size=page_size,
                                   kv_pages=kv_pages, device=self.device)
        self.seq_len = self._pool.seq_len   # KV rows of a prefill and a slot
        self.bucket_prompts = buckets_prompts(cfg)
        if prefill_chunk > 0 and self.bucket_prompts and cfg.kv_cache_bits != 8:
            align = recurrence_alignment(cfg)
            self.chunk = -(-prefill_chunk // align) * align
        else:
            self.chunk = 0
        self.decode_block = decode_block
        self._prefilling: Optional[_PrefillJob] = None
        self._chunks_left = 0            # per-step()/submit() chunk budget
        # device-resident token carry; host mirror of the positions
        self._tok = torch.zeros((capacity, 1), dtype=torch.int32, device=self.device)
        self._pos = np.zeros((capacity,), np.int32)
        self._inflight: Optional[_Inflight] = None
        self._free = list(range(capacity))[::-1]      # pop() -> slot 0 first
        self._used: set = set()
        self._active: Dict[int, _Record] = {}
        self._pending: deque = deque()
        self._records: List[_Record] = []
        self._next_id = itertools.count()
        self._slot_hwm = 0
        self._prefill_shapes: set = set()
        self._decode_ks: set = set()
        self._stats = {"slot_reuses": 0, "decode_steps": 0, "decode_micro_steps": 0,
                       "completed": 0, "admitted": 0, "prefill_chunks": 0}
        self.config: Optional[EngineConfig] = None    # set by EngineConfig.build

    # -- public API ---------------------------------------------------------
    def submit(self, request: Request) -> RequestHandle:
        P = len(request.prompt)
        if P < 1:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not self.cfg.embed_inputs:
            bad = next((t for t in request.prompt if not 0 <= t < self.cfg.vocab), None)
            if bad is not None:
                raise ValueError(f"prompt token id {bad} outside the "
                                 f"vocabulary [0, {self.cfg.vocab})")
        if P > self.max_len:
            raise ValueError(f"prompt length {P} exceeds the engine's "
                             f"max_len budget ({self.max_len})")
        if P + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({request.max_new_tokens}) "
                f"exceeds the engine's max_len ({self.max_len})")
        need = self._pool.pages_needed(P + request.max_new_tokens)
        if self._pool.paged and need > self._pool.page.num_pages:
            raise ValueError(
                f"request needs {need} KV pages but the pool holds only "
                f"{self._pool.page.num_pages} (kv_pages): it could never be admitted")
        rec = _Record(next(self._next_id), request, time.perf_counter())
        self._records.append(rec)
        self._pending.append(rec)
        self._chunks_left = 1
        self._admit_all()
        return RequestHandle(rec)

    def step(self) -> int:
        """One engine tick: host work first (one prefill chunk, admissions:
        it overlaps the macro-step the device is running), then retire that
        macro-step, then dispatch the next.  Returns the decode tokens
        retired (0 when nothing was in flight)."""
        self._chunks_left = 1
        if self._prefilling is not None:
            self._advance_prefill()
        self._admit_all()
        emitted = self._retire()
        self._admit_all()                  # slots and pages freed by _retire
        self._dispatch()
        return emitted

    def drain(self) -> List[Completion]:
        """Step until nothing is pending, prefilling, active or in flight;
        return every completion of this engine, in submission order."""
        while self._pending or self._active or self._prefilling or self._inflight:
            self.step()
        return [r.completion for r in self._records if r.completion is not None]

    @property
    def stats(self) -> Dict[str, int]:
        return {**self._stats,
                "prefill_traces": len(self._prefill_shapes),
                "decode_traces": len(self._decode_ks),
                "queue_depth": len(self._pending),
                "slot_hwm": self._slot_hwm,
                **self._pool.stats()}

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    # -- scheduler internals ------------------------------------------------
    def _pick_k(self) -> int:
        """Micro-steps of the next dispatch: the block size, clipped to the
        fewest tokens any active slot still owes (no slot overshoots
        max_new_tokens, nor the pages admission reserved for it)."""
        left = min(rec.request.max_new_tokens - len(rec.tokens)
                   for rec in self._active.values())
        return max(1, min(self.decode_block, left))

    def _dispatch(self) -> None:
        """Queue the next decode macro-step (nothing when no slot is
        active).  The host mirrors advance at once; the tokens stay on the
        device until ``_retire``."""
        if not self._active or self._inflight is not None:
            return
        k = self._pick_k()
        remaining = np.zeros((self.capacity,), np.int32)
        snapshot, sampled = [], []
        for slot, rec in self._active.items():
            r = rec.request.max_new_tokens - len(rec.tokens)
            remaining[slot] = r
            snapshot.append((slot, rec, min(k, r)))
            if rec.request.temperature > 0:
                sampled.append((slot, rec.request.temperature, rec.generator, min(k, r)))

        def sample(logits, aux):
            # greedy rows by one argmax; each sampled row from its request's
            # generator, drawn only while the row is live (j < n, known here)
            left, j = aux
            live = left > 0
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
            for slot, temp, gen, n in sampled:
                if j < n:
                    toks[slot] = _select(logits[slot:slot + 1], temp, gen)[0, 0]
            return toks, (torch.where(live, left - 1, left), j + 1), live

        self._decode_ks.add(k)
        with torch.no_grad():
            tree, tok, _, _, toks, _ = lm.decode_scan(
                self.serve_params, self._pool.tree, self._tok,
                _upload(self._pos, self.device), self.cfg,
                (_upload(remaining, self.device), 0), sample, k,
                page_table=self._pool.page_table)
        self._pool.tree, self._tok = tree, tok
        for slot, _, n in snapshot:
            self._pos[slot] += n
        self._stats["decode_steps"] += 1
        self._stats["decode_micro_steps"] += k
        self._inflight = _Inflight(toks, snapshot, k)

    def _retire(self) -> int:
        """Wait for the macro-step in flight, append each slot's tokens and
        finish (and free) the slots that reached max_new_tokens: pages are
        freed at this boundary, never inside a macro-step."""
        inf, self._inflight = self._inflight, None
        if inf is None:
            return 0
        toks = inf.toks.cpu().numpy()      # (k, C); waits for the device
        now = time.perf_counter()
        emitted = 0
        for slot, rec, n in inf.snapshot:
            rec.tokens.extend(int(t) for t in toks[:n, slot])
            rec.token_times.extend([now] * n)
            emitted += n
            if len(rec.tokens) >= rec.request.max_new_tokens:
                self._finish(rec)
        return emitted

    def _needs_chunking(self, P: int) -> bool:
        return bool(self.chunk) and P > self.chunk

    def _admit_all(self) -> None:
        # FIFO with head-of-line blocking: a deferred head (pages dry, or a
        # chunked prefill in flight) holds everything behind it, so slot and
        # page assignment is a function of submission order alone
        while self._pending and self._free and self._prefilling is None:
            rec = self._pending[0]
            req = rec.request
            if not self._pool.can_admit(len(req.prompt) + req.max_new_tokens):
                break                      # defer until pages free up
            if self._needs_chunking(len(req.prompt)) and self._chunks_left <= 0:
                break                      # this step's chunk is spent
            self._pending.popleft()
            self._admit(rec)

    def _admit(self, rec: _Record) -> None:
        slot = self._free.pop()
        self._stats["slot_reuses"] += slot in self._used
        self._used.add(slot)
        rec.slot = slot
        self._slot_hwm = max(self._slot_hwm, self.capacity - len(self._free))
        req = rec.request
        P = len(req.prompt)
        self._pool.alloc(slot, P + req.max_new_tokens)
        rec.queue_wait = time.perf_counter() - rec.submit_t
        if req.temperature > 0:
            rec.generator = torch.Generator(self.device).manual_seed(req.seed)
        if self._needs_chunking(P):
            self._prefilling = _PrefillJob(
                rec, fresh_chunk_state(self.cfg, self.seq_len, self.chunk, self.device))
            self._advance_prefill()
            return
        L = prefill_len(self.cfg, P, self.seq_len)
        self._prefill_shapes.add(("bucket", L))
        logits, state = prefill_bucket(self.serve_params, self.cfg, req.prompt, L,
                                       self.seq_len, self.device)
        self._activate(rec, state, logits)

    def _advance_prefill(self) -> None:
        """Run one chunk of the chunked prefill in flight, if this step's
        chunk budget allows."""
        job = self._prefilling
        if job is None or self._chunks_left <= 0:
            return
        self._chunks_left -= 1
        prompt = job.rec.request.prompt
        self._prefill_shapes.add(("chunk", self.chunk))
        logits, job.state = prefill_chunk(self.serve_params, self.cfg, prompt, job.done,
                                          self.chunk, job.state, self.device)
        self._stats["prefill_chunks"] += 1
        job.done = min(job.done + self.chunk, len(prompt))
        if job.done >= len(prompt):
            self._prefilling = None
            self._activate(job.rec, job.state, logits)

    def _activate(self, rec: _Record, state, logits) -> None:
        """Sample the first token, scatter the prefill into the pool and go
        live."""
        slot, req = rec.slot, rec.request
        tok = _select(logits[:, -1], req.temperature, rec.generator)    # (1, 1)
        self._pool.scatter(slot, state)
        self._tok[slot] = tok[0]
        rec.tokens.append(int(tok))
        now = time.perf_counter()
        rec.first_tok_t = now
        rec.token_times.append(now)
        self._pos[slot] = len(req.prompt)
        self._stats["admitted"] += 1
        if req.max_new_tokens == 1:
            self._finish(rec)
        else:
            self._active[slot] = rec

    def _finish(self, rec: _Record) -> None:
        now = time.perf_counter()
        rec.completion = Completion(
            request_id=rec.rid, prompt_len=len(rec.request.prompt),
            tokens=tuple(rec.tokens), ttft_s=rec.first_tok_t - rec.submit_t,
            latency_s=now - rec.submit_t, queue_wait_s=rec.queue_wait,
            token_times=tuple(rec.token_times))
        rec.generator = None
        self._active.pop(rec.slot, None)
        self._free.append(rec.slot)
        self._pool.free(rec.slot)
        self._pos[rec.slot] = 0
        self._stats["completed"] += 1
