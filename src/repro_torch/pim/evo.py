"""Evolution-search-based layer-wise epitome design (EPIM Algorithm 1).

Reward (Eqs. 6-7):   R = m / Latency(E)   or   m / Energy(E)
with m = 1 iff #Crossbar(E) <= Budget else 0 (infeasible individuals are
filtered out of {O}_i, exactly as the pseudo code's size filter).

The search space is the cross product of per-layer candidate epitome shapes
(N^l combinations; the paper's instance has 20,676,608).  Individuals are
integer vectors indexing each layer's candidate list.

A copy of ``repro.pim.evo``: the same ``np.random.default_rng(seed)`` draws
in the same order, so one seed gives one plan in both packages.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.epitome import EpitomeSpec
from .simulator import PimSimulator, SimResult
from .workloads import LayerShape
from .xbar import MappingConfig, make_spec


@dataclasses.dataclass
class EvoConfig:
    population: int = 64
    iterations: int = 30
    parents: int = 16
    mutate_prob: float = 0.15
    objective: str = "latency"       # latency | energy | edp
    wrapping: bool = True
    seed: int = 0


def all_layer_uniform_specs(layers: Sequence[LayerShape], m: int, n: int,
                            cfg: MappingConfig) -> List[Optional[EpitomeSpec]]:
    """Fig-4 style uniform design: every layer that shrinks gets (m, n)."""
    return [make_spec(l, m, n, cfg) for l in layers]


def candidate_specs(layer: LayerShape, cfg: MappingConfig,
                    shapes: Sequence[Tuple[int, int]]) -> List[Optional[EpitomeSpec]]:
    """Per-layer candidate list: dense (None) + every epitome shape that
    actually shrinks the layer."""
    cands: List[Optional[EpitomeSpec]] = [None]
    for (m, n) in shapes:
        s = make_spec(layer, m, n, cfg)
        if s is not None and s not in cands:
            cands.append(s)
    return cands


def encode_individual(specs: Sequence[Optional[EpitomeSpec]],
                      candidates: Sequence[Sequence[Optional[EpitomeSpec]]]
                      ) -> np.ndarray:
    """Genes for a seed design: the index of each layer's spec in its
    candidate list.

    Matches the FULL spec first (so two candidates differing only in patch
    geometry stay distinct), then exact (m, n); a seed spec missing from the
    candidate list falls back to the *nearest* candidate by (m, n) distance
    — with a warning — instead of silently degrading to gene 0 (dense),
    which used to drop known-good seeds from {P}_0 entirely."""
    ind = np.zeros(len(specs), dtype=np.int64)
    for i, s in enumerate(specs):
        cands = candidates[i]
        if s is None:
            ind[i] = next(g for g, c in enumerate(cands) if c is None)
            continue
        exact = next((g for g, c in enumerate(cands) if c == s), None)
        if exact is None:
            exact = next((g for g, c in enumerate(cands)
                          if c is not None and c.m == s.m and c.n == s.n), None)
        if exact is not None:
            ind[i] = exact
            continue
        shaped = [(g, c) for g, c in enumerate(cands) if c is not None]
        if not shaped:
            warnings.warn(
                f"seed spec ({s.m}x{s.n}) for layer {i} has no epitome "
                f"candidate at all; seeding dense", stacklevel=2)
            continue
        g, c = min(shaped,
                   key=lambda gc: (gc[1].m - s.m) ** 2 + (gc[1].n - s.n) ** 2)
        warnings.warn(
            f"seed spec ({s.m}x{s.n}) for layer {i} is not a candidate; "
            f"seeding nearest candidate ({c.m}x{c.n})", stacklevel=2)
        ind[i] = g
    return ind


def _reward(sim: SimResult, objective: str) -> float:
    v = {"latency": sim.latency, "energy": sim.energy, "edp": sim.edp}[objective]
    return 1.0 / v


def evolution_search(
    layers: Sequence[LayerShape],
    candidates: Sequence[Sequence[Optional[EpitomeSpec]]],
    simulator: PimSimulator,
    budget_xbars: int,
    cfg: EvoConfig = EvoConfig(),
    weight_bits: Optional[Sequence[Optional[int]]] = None,
    seeds: Optional[Sequence[Sequence[Optional[EpitomeSpec]]]] = None,
    act_bits: Optional[int] = None,
) -> Tuple[List[Optional[EpitomeSpec]], SimResult, List[float]]:
    """Algorithm 1.  Returns (best specs, its SimResult, best-reward curve).

    ``seeds`` (e.g. the uniform design) are injected into {P}_0 so the
    search explores around known-feasible points as well as random ones.
    Ranking is by the simulator; re-ranking the elite front by measured
    kernel latency (the reference's ``cost=``) comes with the tuning
    slice."""
    rng = np.random.default_rng(cfg.seed)
    n_layers = len(layers)
    sizes = np.array([len(c) for c in candidates])

    def specs_of(ind: np.ndarray) -> List[Optional[EpitomeSpec]]:
        return [candidates[i][g] for i, g in enumerate(ind)]

    def evaluate(ind: np.ndarray) -> Tuple[float, SimResult]:
        sim = simulator.simulate(layers, specs_of(ind), weight_bits,
                                 wrapping=cfg.wrapping, act_bits=act_bits)
        m = 1.0 if sim.xbars <= budget_xbars else 0.0          # Eq. 7
        return m * _reward(sim, cfg.objective), sim             # Eq. 6

    # {P}_0.init(): seeds (uniform/known designs) + random individuals
    pop = [encode_individual(s, candidates) for s in (seeds or [])]
    pop += [rng.integers(0, sizes) for _ in range(cfg.population - len(pop))]
    best_curve: List[float] = []
    best_ind, best_r, best_sim = None, -1.0, None

    for it in range(cfg.iterations):
        # filter by model size (budget) then evaluate — lines 3-7
        scored = []
        for ind in pop:
            r, sim = evaluate(ind)
            scored.append((r, ind, sim))
            if r > best_r:
                best_r, best_ind, best_sim = r, ind.copy(), sim
        best_curve.append(best_r)
        # select good candidates — line 9
        scored.sort(key=lambda t: -t[0])
        parents = [ind for _, ind, _ in scored[: cfg.parents]]
        # mutate parents — lines 10-14
        nxt: List[np.ndarray] = list(parents)
        while len(nxt) < cfg.population:
            parent = parents[rng.integers(len(parents))]
            child = parent.copy()
            mask = rng.random(n_layers) < cfg.mutate_prob
            if not mask.any():
                mask[rng.integers(n_layers)] = True
            child[mask] = rng.integers(0, sizes[mask])
            nxt.append(child)
        pop = nxt

    assert best_ind is not None, "no feasible individual found; raise budget"
    return specs_of(best_ind), best_sim, best_curve
