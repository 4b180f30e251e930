"""Parameters of the JAX models into this package.

The two frameworks draw different numbers from the same seed, so parameters
cross as numpy: each function takes the reference's parameter tree (nested
dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``).

``params_from_jax`` returns the same tree of torch tensors for the
``ResNetModel`` (``ResNetModel.load_params`` takes it).  Names and layouts
carry over unchanged: ``E`` (m, n), dense ``W`` in HWIO (conv) or (M, N)
(fc), the prepacked int8 ``Eq`` with its ``Es``/``Ez``, and ``bn_g``/
``bn_b``; the inventory names keep their dots (only the module dict maps
them).

``lm_params_from_jax`` returns the LM's tree as ``models.lm`` keeps it: the
reference stacks every group leaf over a leading group axis, the port keeps
a list of per-group dicts, so ``groups`` is unstacked.  The MoE FFN's
``router`` and its expert tensors cross the same way: ``w_gate``, ``w_up``
and ``w_down`` are arrays under ``moe`` ((G, E, d, ff) stacked) and dicts
(``E``, ``Eq``, ...) under the dense FFN.  The Mamba mixer's leaves are
its projections' dicts (``in_proj``, ``x_proj``, ``dt_proj`` with its bias
``b``, ``out_proj``), the conv's ``conv_w`` and ``conv_b``, and ``A_log``
and ``D``, which stay float32.
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


LM_LEAVES = ("embed", "head", "final_norm", "norm1", "norm2",
             "mu", "lora_A", "lora_B", "w0", "wd_A", "wd_B", "u", "ln_x",
             "mu_k", "mu_r", "E", "W", "b", "Eq", "Es", "Ez",
             "router", "w_gate", "w_up", "w_down",
             "conv_w", "conv_b", "A_log", "D")


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A copy of a numpy array as a tensor; bfloat16 arrays (ml_dtypes',
    which numpy cannot hand to torch) cross by their 16 bits."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, copy=True).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _lm_tree(tree: Mapping, device, index=None) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _lm_tree(v, device, index)
        elif k in LM_LEAVES:
            a = np.asarray(v) if index is None else np.asarray(v)[index]
            out[k] = _tensor(a).to(device)
        else:
            raise KeyError(f"unknown LM parameter leaf {k!r} (expected one of {LM_LEAVES})")
    return out


def lm_params_from_jax(tree: Mapping, cfg, device="cuda") -> dict:
    """The reference LM's parameter tree (``embed``, ``groups`` stacked over
    cfg.n_groups, ``final_norm``, ``head``) -> the port's, with ``groups`` a
    list of cfg.n_groups dicts; rejects leaf names the port does not know."""
    out = _lm_tree({k: v for k, v in tree.items() if k != "groups"}, device)
    out["groups"] = [_lm_tree(tree["groups"], device, g) for g in range(cfg.n_groups)]
    return out
