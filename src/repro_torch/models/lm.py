"""Full language model: init, prepack, forward, loss, prefill and decode
(counterpart of ``repro.models.lm``).

The reference stacks every group's leaves over a leading group axis and
``lax.scan``s over it.  The port keeps ``params["groups"]`` as a list of
per-group dicts (and the decode state as a list of per-group states) and
loops over them in Python: PyTorch runs eagerly, so a scan buys nothing,
and per-group tensors need no slicing.  ``convert.lm_params_from_jax``
unstacks the reference's tree into this layout.

On a mesh (``launch.mesh``), ``prepack_params(mesh=)`` / ``shard_params``
lay the parameters out by the plan's placements and the serving specs,
and ``init_decode_state(mesh=)`` the state by ``state_specs``: each rank
holds its blocks (``core.layers.Sharded``).  A layer gathers its blocks
where it reads them and every rank computes every row, so the sharded
model's logits are the one-card model's bit for bit.  The specs are the
reference's with its leading group axis dropped (the port has none).

Training on a mesh (``train.loop.init_state(mesh=)``) lays the parameters
out by the training specs (``shard_params(serving=False)``: fan-in over
'data', fan-out over 'model') and splits each batch's rows over the batch
axes (``common.split_rows``): ``loss_fn`` divides by the whole batch's
token count, so the ranks' gradients sum to the whole batch's.  A layer
gathers its weights inside its remat group, so they live whole only while
the group computes, and the recompute gathers them again.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.layers import (EpLayerConfig, Sharded, lay_out, lay_out_as, placement_pspec,
                           prepack_tree, unshard)
from ..train.tree import leaves, tree_map
from .attention import kv_cache_spec
from .blocks import apply_group, decode_group, init_group, init_group_state, prefill_group
from .common import (BATCH_AXES, TENSOR_AXIS, all_reduce_batch, embed_lookup,
                     init_rms_norm, rms_norm, rows_split, unembed)
from .config import ModelConfig
from .ssm import last_real


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` on its own device (a CUDA
    generator draws a full-size model on the card), placed on ``device``."""
    def randn(*shape):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t / math.sqrt(cfg.d_model)).to(device=device, dtype=cfg.pdtype)

    params = {"embed": randn(cfg.vocab, cfg.d_model),
              "groups": [init_group(generator, cfg, device) for _ in range(cfg.n_groups)],
              "final_norm": init_rms_norm(cfg.d_model, cfg.pdtype, device)}
    if not cfg.tie_embeddings:
        params["head"] = randn(cfg.d_model, cfg.vocab)
    return params


def lm_layer_configs(cfg: ModelConfig) -> Dict[str, EpLayerConfig]:
    """Every projection site's EpLayerConfig, keyed by param-tree path,
    enumerated from pim.workloads.lm_layers — the sites init, forward and
    prepack resolve by name."""
    from ..pim.workloads import lm_layers
    return {l.name: cfg.ep(l.rows, l.cols, l.name) for l in lm_layers(cfg)}


def needs_prepack(cfg: ModelConfig) -> bool:
    """True iff any projection runs the fused kernel x quant path."""
    return any(lc.is_epitome and lc.quant is not None and lc.mode == "kernel"
               for lc in lm_layer_configs(cfg).values())


def prepack_params(params: Dict[str, Any], cfg: ModelConfig, mesh=None) -> Dict[str, Any]:
    """Pack every kernel x quant epitome once (int8 codes + per-block scale
    and zero beside E), so every forward feeds the kernel stored codes.

    With ``mesh``, ``prepack_tree`` lays the packed codes of the layers
    with a placement record out as it makes them, and ``shard_params``
    covers the rest of the tree (embedding, head, layers without a record)
    with the serving specs: one call gives the sharded serving tree."""
    configs = lm_layer_configs(cfg)
    with torch.no_grad():
        groups = [prepack_tree(g, configs, mesh=mesh) for g in params["groups"]]
    out = {**params, "groups": groups}
    return out if mesh is None else shard_params(out, cfg, mesh)


# ---------------------------------------------------------------------------
# Sharding specs (FSDP over 'data', TP over 'model'), the reference's rules.
#
# A layer the plan-driven ``cfg.layer_config`` names with a placement record
# is sharded as the plan says (placement_pspec); everything else falls back
# to the role rules below: _leaf_spec (training FSDP x TP) or
# _serving_leaf_spec (column-parallel serving).  The rules read a group
# leaf's shape with the reference's leading group axis (``(1,) + shape``)
# and param_specs drops that axis from their answer.
# ---------------------------------------------------------------------------
def _leaf_spec(path: str, shape: Tuple[int, ...]) -> tuple:
    """Spec by parameter role.  Fan-in is FSDP-sharded over 'data', fan-out
    TP-sharded over 'model' (transposed for down/out projections so the
    large d_ff/heads dim is always on 'model')."""
    def last(*names):
        return any(path.endswith(n) for n in names)

    if last("/embed"):
        return (TENSOR_AXIS, "data")
    if last("/head"):
        return ("data", TENSOR_AXIS)
    if last("/router"):
        return (None, None)
    # prepacked codes Eq shard like E; the per-block scale grids replicate
    if path.endswith("/Eq"):
        return _leaf_spec(path[:-1], shape)
    if path.endswith("/Es") or path.endswith("/Ez"):
        return (None,) * len(shape)
    # rwkv channel mix under /ffn/: wk, wr (d, ff) fan-out, wv (ff, d) fan-in
    if "/ffn/" in path:
        if last("wk/W", "wk/E", "wr/W", "wr/E"):
            return (None, "data", TENSOR_AXIS)
        if last("wv/W", "wv/E"):
            return (None, TENSOR_AXIS, "data")
    fan_out = ("wq/W", "wk/W", "wv/W", "wg/W", "wr/W", "in_proj/W",
               "x_proj/W", "dt_proj/W", "w_gate/W", "w_up/W", "w_gate",
               "w_up", "wq/E", "wk/E", "wv/E", "wg/E", "wr/E", "in_proj/E",
               "x_proj/E", "dt_proj/E", "w_gate/E", "w_up/E")
    fan_in = ("wo/W", "out_proj/W", "w_down/W", "w_down", "wo/E",
              "out_proj/E", "w_down/E")
    if last(*fan_out):
        if len(shape) == 4:        # stacked MoE experts (G, E, d, ff)
            return (None, None, "data", TENSOR_AXIS)
        return (None, "data", TENSOR_AXIS)
    if last(*fan_in):
        if len(shape) == 4:
            return (None, None, TENSOR_AXIS, "data")
        return (None, TENSOR_AXIS, "data")
    return (None,) * len(shape)


def _serving_leaf_spec(path: str, shape: Tuple[int, ...]) -> tuple:
    """Serving default for layers no plan names: the role-based
    column-parallel placement (core.placement.default_placement) by path.
    Only output dims shard; contraction dims stay whole."""
    from ..core.placement import default_placement
    if path.endswith("/embed"):
        return (TENSOR_AXIS, None)
    if path.endswith("/head"):
        return (None, TENSOR_AXIS)
    if path.endswith("/router"):
        return (None, None)
    name, _, leaf = path.rpartition("/")
    name = name[len("/groups/"):] if name.startswith("/groups/") else name
    if leaf in ("E", "W", "Eq", "Es", "Ez", "b") and name:
        return placement_pspec(default_placement(name), leaf, len(shape))
    return (None,) * len(shape)


def _map_specs(tree, prefix: str, leaf_fn):
    if isinstance(tree, dict):
        return {k: _map_specs(v, f"{prefix}/{k}", leaf_fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(v, f"{prefix}/{i}", leaf_fn) for i, v in enumerate(tree))
    return leaf_fn(prefix, tuple(tree.shape))


def param_specs(cfg: ModelConfig, params: Dict[str, Any], *,
                serving: bool = False) -> Dict[str, Any]:
    """The spec tree of ``params`` (one entry a dim: a mesh axis, a tuple of
    axes or None).  Layers the plan-driven ``cfg.layer_config`` names are
    sharded by their placement record; the other leaves by the role rules,
    FSDP x TP for training or column-parallel serving (``serving=True``)."""
    placements = {name: lc.placement for name, lc in cfg.layer_config
                  if lc.placement is not None}
    fallback = _serving_leaf_spec if serving else _leaf_spec

    def group_leaf(path, shape):
        name, _, leaf = path.rpartition("/")
        pl = placements.get(name[len("/groups/"):])
        if pl is not None:
            return placement_pspec(pl, leaf, len(shape))
        return fallback(path, (1,) + shape)[1:]

    return {k: ([_map_specs(g, "/groups", group_leaf) for g in v] if k == "groups"
                else _map_specs(v, f"/{k}", fallback))
            for k, v in params.items()}


def shard_params(params: Dict[str, Any], cfg: ModelConfig, mesh, *,
                 serving: bool = True) -> Dict[str, Any]:
    """Lay a (possibly prepacked) parameter tree out on ``mesh``: plan
    placements where the config carries them, elsewhere the serving
    defaults or (``serving=False``) the training specs; axes that do not
    divide their dim degrade to replicated.  Leaves already laid out
    (``prepack_params(mesh=)``) stay as they are; a replicated leaf stays a
    plain tensor."""
    specs = param_specs(cfg, params, serving=serving)
    return tree_map(lambda t, sp: t if isinstance(t, Sharded) else lay_out(t, sp, mesh),
                    params, specs, tuples=False)


def _embed(params: Dict[str, Any], inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token ids (B, S) -> scaled embeddings; (B, S, d) embeddings (the
    modality stubs' frame or patch inputs) pass through in the compute
    dtype."""
    if inputs.ndim != 2:
        return inputs.to(cfg.cdtype)
    x = embed_lookup(unshard(params["embed"]), inputs, cfg.cdtype)
    # the scale rounded to the compute dtype first, as jnp.asarray(..., cdtype)
    return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype))


def _logits(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = unshard(params["head"]) if "head" in params else unshard(params["embed"]).T
    return unembed(x, head, cfg.logit_softcap)


# the matmuls without batch dims (x @ W flattens to aten.mm), which
# remat_policy "dots" keeps, as jax's dots_with_no_batch_dims_saveable keeps
# dot_generals without batch dims (a batched einsum is a bmm: recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_group(group, x, cfg: ModelConfig, positions):
    """apply_group under activation checkpointing (the reference's
    jax.checkpoint): the backward runs the group again, keeping nothing of
    its first run but its input, or (remat_policy "dots") its matmul
    outputs too.  The forward draws no random numbers, so no RNG state is
    kept."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy != "nothing":
        raise ValueError(f"{cfg.name}: remat_policy {cfg.remat_policy!r} is not "
                         f"'nothing' or 'dots'")
    return checkpoint(apply_group, group, x, cfg, positions, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def forward(params: Dict[str, Any], inputs: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor] = None, remat: bool = True) -> torch.Tensor:
    """inputs: (B, S) int token ids, or (B, S, d) embeddings.  Returns
    logits (B, S, vocab).  ``positions`` ((S,) or (B, S)) place RoPE;
    0..S-1 by default.  ``remat``: where autograd records, each group runs
    under activation checkpointing (``cfg.remat_policy``), as the reference
    remats each group of its scan; without grad it changes nothing."""
    x = _embed(params, inputs, cfg)
    body = _remat_group if remat and torch.is_grad_enabled() else apply_group
    for group in params["groups"]:
        x = body(group, x, cfg, positions)
    return _logits(params, x, cfg)


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross entropy, the mean over the tokens of ``mask``.
    batch: tokens (B, S) (or embeds (B, S, d)), labels (B, S), optional
    mask (B, S).  Logits in float32; the label's log-likelihood by gather,
    the same numbers as the reference's one-hot select.  With the rows
    split over the batch axes (``common.split_rows``), ``batch`` is this
    rank's rows and the mean is over the whole batch's tokens: the sum of
    the ranks' losses (and gradients) is the whole batch's."""
    inputs = batch["embeds"] if "embeds" in batch else batch["tokens"]
    logits = forward(params, inputs, cfg).to(torch.float32)
    labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.to(torch.long)[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
    nll = (logz - ll) * mask
    count = mask.sum()
    if rows_split():
        count = all_reduce_batch(count.detach().clone())
    return nll.sum() / count.clamp_min(1.0)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda", mesh=None) -> List[Dict[str, Any]]:
    """One decode state per group; ``max_len`` rows of KV cache for each
    attention layer.  With ``mesh``, laid out by ``state_specs``."""
    state = [init_group_state(cfg, batch, max_len, device) for _ in range(cfg.n_groups)]
    if mesh is None:
        return state
    return tree_map(lambda t, sp: lay_out(t, sp, mesh), state, state_specs(cfg, state, batch),
                    tuples=False)


def state_specs(cfg: ModelConfig, state: List[Dict[str, Any]], batch: int) -> List[Dict[str, Any]]:
    """The decode state's spec tree, the reference's rules: KV caches batch
    over the batch axes and sequence over 'model' (a batch of one:
    sequence over every axis); the RWKV state over batch and heads, the
    Mamba state over batch and channels."""
    b = BATCH_AXES if batch > 1 else None

    def leaf(path, shape):
        if path.endswith(("/k", "/v", "/k_s", "/v_s")):      # (B, S, Hkv, hd | 1)
            return (kv_cache_spec(BATCH_AXES, TENSOR_AXIS) if batch > 1
                    else kv_cache_spec(None, ("pod", "data", "model")))
        if path.endswith("/s"):             # rwkv (B, H, K, V)
            return (b, TENSOR_AXIS, None, None)
        if path.endswith("/h"):             # mamba (B, di, ds)
            return (b, TENSOR_AXIS, None)
        if path.endswith("/conv"):          # (B, dc - 1, di)
            return (b, None, TENSOR_AXIS)
        return (None,) * len(shape)
    return _map_specs(state, "", leaf)


def _whole_state(state: List[Dict[str, Any]]):
    """(state with its laid-out leaves gathered, the ``Sharded`` leaves to
    lay the new state out like, or None when nothing is laid out)."""
    if not any(isinstance(t, Sharded) for t in leaves(state)):
        return state, None
    return tree_map(unshard, state), state


def _lay_out_like(state: List[Dict[str, Any]], like) -> List[Dict[str, Any]]:
    return state if like is None else tree_map(lay_out_as, state, like)


def prefill(params: Dict[str, Any], inputs: torch.Tensor, state: List[Dict[str, Any]],
            cfg: ModelConfig, positions: Optional[torch.Tensor] = None,
            valid_len=None, chunk_start=None) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """Run the prompt ((B, S) ids or (B, S, d) embeddings) and fill the
    decode state.  Returns (last-token logits (B, 1, vocab), new state).
    The attention caches of ``state`` are written in place (the returned
    state holds the same tensors); the recurrent kinds' state is returned
    new.

    ``valid_len`` (an int or a 0-d device tensor) marks a right-padded
    prefill, as the serving engine pads prompts to buckets: only the first
    ``valid_len`` rows are real, the logits are taken at row ``valid_len -
    1`` and the pads leave the recurrent state as the last real token left
    it.  ``chunk_start`` (an int or a 0-d device tensor) makes ``inputs``
    one chunk of a chunked prefill at positions chunk_start +
    arange(S), against a state that carries the earlier chunks (its
    attention caches in float); ``valid_len`` then counts the chunk's real
    rows.  A state laid out on a mesh is gathered here and the new state
    laid out as it was."""
    state, like = _whole_state(state)
    x = _embed(params, inputs, cfg)
    new_state = []
    for group, st in zip(params["groups"], state):
        x, st = prefill_group(group, st, x, cfg, positions, valid_len, chunk_start)
        new_state.append(st)
    return (_logits(params, last_real(x, valid_len)[:, None], cfg),
            _lay_out_like(new_state, like))


def decode_step(params: Dict[str, Any], state: List[Dict[str, Any]], token: torch.Tensor,
                pos, cfg: ModelConfig, page_table=None
                ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """token: (B, 1) int ids or (B, 1, d) embeddings; ``pos`` the token's
    sequence position: an int, or a device tensor, scalar or (B,) per row
    (never read by the host).  Returns (logits (B, 1, vocab), new state);
    the attention caches of ``state`` are written in place at ``pos``.
    ``page_table`` ((B, pages per slot) int, per-row ``pos``): the
    attention caches are the serving engine's block-paged pool
    (``models.kv_pool``), read and written through the table.  A state
    laid out on a mesh is gathered and laid out again, as in ``prefill``."""
    state, like = _whole_state(state)
    x = _embed(params, token, cfg)
    new_state = []
    for group, st in zip(params["groups"], state):
        x, st = decode_group(group, st, x, pos, cfg, page_table)
        new_state.append(st)
    return _logits(params, x, cfg), _lay_out_like(new_state, like)


def decode_scan(params: Dict[str, Any], state: List[Dict[str, Any]], tok: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig, aux: Any,
                sample: Callable, k: int, page_table=None):
    """``k`` decode micro-steps in one call: the serving engine's fused
    macro-step (the reference's ``lax.scan``; here a Python loop that reads
    nothing back from the device, so it can be captured in a CUDA graph).

    ``sample(logits, aux) -> (toks, aux, live)`` is the caller's sampling
    policy: ``logits`` the (B, vocab) rows of this micro-step, ``toks`` the
    (B,) next tokens, ``live`` a (B,) bool device mask of the rows still
    generating.  A row that is not live is frozen: its token and position
    stop advancing (``torch.where`` on the device), so it rewrites the KV
    row it already owns; its recurrent state runs on into garbage that the
    next admission overwrites.  ``tok`` (B, 1) and ``pos`` (B,) are device
    tensors.  ``page_table`` is the same for every micro-step: admission
    maps every page a request will touch.

    Returns (state, tok, pos, aux, toks (k, B), live (k, B))."""
    toks, lives = [], []
    for _ in range(k):
        logits, state = decode_step(params, state, tok, pos, cfg, page_table)
        nxt, aux, live = sample(logits[:, -1], aux)
        tok = torch.where(live[:, None], nxt[:, None].to(tok.dtype), tok)
        pos = torch.where(live, pos + 1, pos)
        toks.append(nxt)
        lives.append(live)
    return state, tok, pos, aux, torch.stack(toks), torch.stack(lives)
