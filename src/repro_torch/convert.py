"""Parameters of the JAX ``ResNetModel`` into this package.

The two frameworks draw different numbers from the same seed, so parameters
cross as numpy: ``params_from_jax`` takes the reference's parameter tree
(nested dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``)
and returns the same tree of torch tensors, which
``ResNetModel.load_params`` takes.  Names and layouts carry over unchanged:
``E`` (m, n), dense ``W`` in HWIO (conv) or (M, N) (fc), the prepacked
int8 ``Eq`` with its ``Es``/``Ez``, and ``bn_g``/``bn_b``; the inventory
names keep their dots (only the module dict maps them).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

LEAVES = ("E", "W", "b", "Eq", "Es", "Ez", "bn_g", "bn_b")


def params_from_jax(tree: Mapping, device="cuda") -> dict:
    """Nested dicts of numpy arrays -> the same nesting of torch tensors on
    ``device``; rejects leaf names the port does not know."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = params_from_jax(v, device)
        elif k in LEAVES:
            out[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
        else:
            raise KeyError(f"unknown parameter leaf {k!r} (expected one of {LEAVES})")
    return out
