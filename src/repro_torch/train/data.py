"""Deterministic synthetic data (counterpart of ``repro.train.data``).

A batch is a pure function of (seed, step), so a restarted job resumes the
exact stream at its step with no data state in the checkpoint, and any host
can make any slice.  Tokens follow a Zipf-like law with a Markov backbone
so that the loss moves while training (uniform tokens give a flat loss):
with probability 1/2 token t+1 follows token t by a fixed map, labels are
the tokens shifted by one.  The draws come from a ``torch.Generator``
seeded by (seed, step), so the bits differ from the reference's
``jax.random`` ones; tests that compare the two feed both one batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch


def _seed(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step), distinct per pair."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


@dataclasses.dataclass(frozen=True)
class SyntheticData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_dim: int = 0          # >0: also emit frame/patch embeddings (stub)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens" (B, S) int32, "labels" (B, S) int32, "mask" (B, S)
        float32[, "embeds" (B, S, embed_dim) float32]} on the CPU."""
        gen = torch.Generator().manual_seed(_seed(self.seed, step))
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # Zipf marginals via an exponential transform of uniforms in [1e-6, 1)
        u = torch.rand((B, S + 1), generator=gen) * (1.0 - 1e-6) + 1e-6
        zipf = torch.floor(torch.exp(u * math.log(float(V)))) - 1
        base = zipf.to(torch.int64) % V
        # Markov backbone: with p = 0.5, token t+1 = f(token t)
        follow = (base * 31 + 7) % V
        coin = torch.rand((B, S + 1), generator=gen) < 0.5
        toks = torch.where(coin, torch.roll(follow, 1, dims=1), base).to(torch.int32)
        out = {"tokens": toks[:, :S].contiguous(), "labels": toks[:, 1:].contiguous(),
               "mask": torch.ones((B, S), dtype=torch.float32)}
        if self.embed_dim:
            out["embeds"] = torch.randn((B, S, self.embed_dim), generator=gen) * 0.02
        return out

    def host_batch(self, step: int, host_id: int, n_hosts: int,
                   accum: int = 1) -> Dict[str, torch.Tensor]:
        """The rows of the global batch that host (or data rank) ``host_id``
        of ``n_hosts`` feeds (``host_rows``)."""
        return host_rows(self.batch(step), host_id, n_hosts, accum)


def host_rows(batch: Dict[str, torch.Tensor], host_id: int, n_hosts: int,
              accum: int = 1) -> Dict[str, torch.Tensor]:
    """Host ``host_id``'s rows of a global batch of B rows, as a train step
    with ``accum`` microbatches cuts them: microbatch i is rows [i B/accum,
    (i + 1) B/accum) of the whole, and the host takes its ``host_id``-th
    part of each, in order, so that its own i-th microbatch is its part of
    the whole's.  With ``accum`` 1, the contiguous rows [h B/n, (h + 1)
    B/n)."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % (n_hosts * accum):
            raise ValueError(f"a batch of {B} rows does not split into {accum} "
                             f"microbatch(es) over {n_hosts} host(s)")
        per = B // (n_hosts * accum)
        parts = v.reshape(accum, n_hosts, per, *v.shape[1:])[:, host_id]
        out[k] = parts.reshape(accum * per, *v.shape[1:])
    return out
