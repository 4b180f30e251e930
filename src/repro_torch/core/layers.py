"""Epitome-backed linear and conv layers and their dense twins.

Functional, as in ``repro.core.layers``: ``init_*`` returns a dict of
tensors named as the reference names them (``E`` or ``W``, and after
``prepack_linear`` the int8 ``Eq`` with its ``Es``/``Ez``), ``apply_*``
consumes it.  The EpitomeSpec is static configuration, never a tensor.

Execution modes for an epitomized weight:
  'reconstruct' — materialize W then matmul (paper-faithful baseline).
  'wrapped'     — channel wrapping (§5.3): compute unique output-column
                  blocks only, expand with a static gather.
  'folded'      — epitome-space matmul: fold activations into epitome rows,
                  multiply in the compressed space, expand by gather.
  'kernel'      — the epitome matmul kernels of ``kernels/``; with ``quant``
                  the fused int8 kernel, the paper's flagship configuration.

Linear layers and convolutions share one dispatcher: a conv lowers to its
im2col patch matrix (rows = output positions, cols = kh*kw*cin) and runs
the same ladder.  'kernel' is inference-only, as in the reference, whose
Pallas kernels have no gradient: with quant the int8 codes are rounded with
no straight-through estimator, and the unquantized kernel has no backward
kernel, so both backwards raise.  Training runs 'folded' (folded-q3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ops import (PackedEpitome, epitome_matmul, pack_blocks,
                           pack_epitome, quant_epitome_matmul)
from .epitome import (EpitomeSpec, epitome_matmul_ref, folded_matmul,
                      init_epitome, reconstruct, wrapped_matmul)
from .placement import LayerPlacement
from .quant import QuantConfig, dequantize_packed, fake_quant


@dataclasses.dataclass(frozen=True)
class EpLayerConfig:
    """Static config attached to each (potentially) epitomized layer."""
    spec: Optional[EpitomeSpec] = None       # None -> dense layer
    mode: str = "wrapped"                    # reconstruct | wrapped | folded | kernel
    quant: Optional[QuantConfig] = None      # None -> fp weights
    placement: Optional[LayerPlacement] = None   # carried from the plan; None -> role default
    # autotuned kernel blocks (bt, bk, bn); None -> the ops.py heuristics.
    # fused_fold selects the kernel that folds the activation itself.
    blocks: Optional[Tuple[int, int, int]] = None
    fused_fold: bool = False

    @property
    def is_epitome(self) -> bool:
        return self.spec is not None


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------
def init_linear(generator: torch.Generator, M: int, N: int, cfg: EpLayerConfig,
                *, bias: bool = False, dtype=torch.float32, device="cuda") -> dict:
    """Weights drawn on the generator's device, then moved to ``device``."""
    p = {}
    if cfg.is_epitome:
        p["E"] = init_epitome(generator, cfg.spec, dtype=dtype, device=device)
    else:
        W = torch.randn((M, N), generator=generator, device=generator.device) / math.sqrt(M)
        p["W"] = W.to(device=device, dtype=dtype)
    if bias:
        p["b"] = torch.zeros((N,), dtype=dtype, device=device)
    return p


class _QuantKernel(torch.autograd.Function):
    """The fused quantized-epitome kernel, opaque to autograd.  E is an
    input only so that a graph through a trainable epitome reaches this
    backward, which refuses: the int8 codes have no straight-through
    estimator, so differentiating would silently train nothing."""

    @staticmethod
    def forward(ctx, x, E, cfg: EpLayerConfig, packed: PackedEpitome):
        return quant_epitome_matmul(x, None, cfg.spec, cfg.quant, packed=packed,
                                    fused_fold=cfg.fused_fold)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "mode='kernel' with quant is inference-only: the packed int8 "
            "codes have no straight-through estimator. Train under "
            "quantization with a fake-quant mode (e.g. 'folded'/folded-q3) "
            "and switch to the fused kernel for serving.")


class _FpKernel(torch.autograd.Function):
    """The epitome kernel (#3), opaque to autograd: its backward refuses,
    as ``jax.grad`` through the reference's ``pallas_call`` does."""

    @staticmethod
    def forward(ctx, x, E, spec):
        return epitome_matmul(x, E, spec)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "mode='kernel' is inference-only: the epitome kernel has no "
            "backward. Train with mode='folded' (the 'folded' or 'folded-q3' "
            "variants) and serve the trained epitomes with the kernel.")


def _pack(E: torch.Tensor, cfg: EpLayerConfig) -> PackedEpitome:
    with torch.no_grad():
        return pack_epitome(E, cfg.spec, cfg.quant, blocks=cfg.blocks)


def prepack_linear(params: dict, cfg: EpLayerConfig) -> dict:
    """Inference-time prepack for the fused quantized-epitome path: quantize
    the epitome once (int8 codes + per-block scale/zero) and store it beside
    E, so every apply feeds the kernel stored codes.  Conv epitomes carry
    the same {"E": ...} structure, so this packs them too.  A no-op for
    every other layer kind."""
    if not (cfg.is_epitome and cfg.quant is not None and cfg.mode == "kernel"):
        return params
    p = _pack(params["E"], cfg)
    return {**params, "Eq": p.q, "Es": p.scales, "Ez": p.zeros}


def _packed_of(params: dict, cfg: EpLayerConfig) -> PackedEpitome:
    """Rebuild the PackedEpitome from prepacked entries (block sizes are
    deterministic from spec + qcfg, so only the arrays are stored)."""
    bk, bn = pack_blocks(cfg.spec, cfg.quant, cfg.blocks)
    return PackedEpitome(params["Eq"], params["Es"], params["Ez"], bk, bn)


def effective_weight(params: dict, cfg: EpLayerConfig) -> torch.Tensor:
    """The (possibly fake-quantized) weight a layer multiplies by: the
    reference the kernel modes are compared against on aligned specs."""
    if cfg.is_epitome:
        E = params["E"]
        if cfg.quant is not None:
            if cfg.mode == "kernel":
                # mirror the fused path's packed (int8, per-block s/z) quant
                p = _pack(E, cfg)
                E = dequantize_packed(p.q, p.scales, p.zeros,
                                      (p.bk, p.bn)).to(E.dtype)
            else:
                E = fake_quant(E, cfg.spec, cfg.quant)
        return reconstruct(E, cfg.spec)
    W = params["W"]
    if cfg.quant is not None:
        W = fake_quant(W, None, cfg.quant)
    return W


def _dispatch_epitome_matmul(params: dict, x: torch.Tensor,
                             cfg: EpLayerConfig) -> torch.Tensor:
    """(…, M) @ W(E) -> (…, N) through the full mode x quant matrix, shared
    by linear layers and (via their im2col patch matrix) convolutions."""
    E = params["E"]
    if cfg.mode == "kernel":
        if cfg.quant is not None:
            packed = _packed_of(params, cfg) if "Eq" in params else _pack(E, cfg)
            return _QuantKernel.apply(x, E, cfg, packed)
        return _FpKernel.apply(x, E, cfg.spec)
    if cfg.quant is not None:
        E = fake_quant(E, cfg.spec, cfg.quant)
    if cfg.mode == "reconstruct":
        return epitome_matmul_ref(x, E, cfg.spec)
    if cfg.mode == "wrapped":
        return wrapped_matmul(x, E, cfg.spec)
    if cfg.mode == "folded":
        return folded_matmul(x, E, cfg.spec)
    raise ValueError(f"unknown mode {cfg.mode}")


# ---------------------------------------------------------------------------
# Sharded serving: placement specs, the layout step, gather at the layer
# ---------------------------------------------------------------------------
def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh (a ``DeviceMesh``, or already a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# the mesh axes a batch's rows are split over when training (models.common
# re-exports them); every other axis ('model') computes the same rows
BATCH_AXES = ("pod", "data")


class Sharded:
    """A tensor laid out on a mesh: ``local`` is this rank's block of the
    whole ``shape``, split along each dim over the mesh axes that ``spec``
    names for it (None: whole; a tuple of axes splits over their product,
    the first axis major).  ``full()`` gathers the blocks back with
    ``all_gather`` over each named axis's group, so a layer computes on the
    very tensor one card would hold; a dim whose axes all have size 1 is
    whole already and costs no copy (a (1, 1) mesh gathers nothing).

    The gather has a gradient (``_Gather``): ``local`` is what trains.
    Over a batch axis, where each rank computed other rows (inside
    ``models.common.split_rows``), the whole gradient is summed and this
    rank keeps its block (``reduce_scatter``); over 'model', whose ranks
    computed the same rows on the same whole weight, and over a batch axis
    outside ``split_rows`` (every rank computed every row), it keeps its
    block and sums nothing.  The sum over a batch axis the spec does not
    name is the caller's (``train.loop``)."""

    __slots__ = ("local", "spec", "shape", "mesh")

    def __init__(self, local: torch.Tensor, spec: Tuple, shape, mesh):
        self.local, self.spec, self.shape, self.mesh = local, tuple(spec), torch.Size(shape), mesh

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    def is_split(self) -> bool:
        """True when this rank holds less than the whole."""
        return self.local.shape != self.shape

    def like(self, local: torch.Tensor) -> "Sharded":
        """Another tensor laid out as this one (``local`` its block)."""
        return Sharded(local, self.spec, self.shape, self.mesh)

    def split_axes(self) -> Tuple[str, ...]:
        """The mesh axes (of size > 1) this tensor is split over."""
        sizes = axis_sizes(self.mesh)
        return tuple(a for e in self.spec for a in mesh_axes(e) if sizes[a] > 1)

    def _steps(self):
        """(dim, axis) of each gather in order: the innermost axis of a dim
        first, its blocks being adjacent in the dim."""
        sizes = axis_sizes(self.mesh)
        return [(dim, a) for dim, entry in enumerate(self.spec)
                for a in reversed(mesh_axes(entry)) if sizes[a] > 1]

    def full(self) -> torch.Tensor:
        if not self.is_split():
            return self.local
        return _Gather.apply(self.local, self)

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, spec={self.spec}, "
                f"local={tuple(self.local.shape)}, dtype={self.local.dtype})")


class _Gather(torch.autograd.Function):
    """``Sharded.full`` as autograd sees it: forward ``all_gather`` over
    each axis of the spec; backward, in the reverse order, a
    ``reduce_scatter`` (a sum) over a batch axis when the forward ran with
    the rows split (``models.common.split_rows``: each rank's gradient is
    its rows' part), and this rank's block of the gradient over any other
    axis, or over a batch axis with every row on every rank (each rank
    then holds the whole gradient already)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, sh: Sharded) -> torch.Tensor:
        import torch.distributed as dist
        from ..models.common import rows_split
        ctx.sh, ctx.rows_split = sh, rows_split()
        t = local
        for dim, a in sh._steps():
            parts = [torch.empty_like(t) for _ in range(axis_sizes(sh.mesh)[a])]
            dist.all_gather(parts, t.contiguous(), group=sh.mesh.get_group(a))
            t = torch.cat(parts, dim)
        if t.shape != sh.shape:
            raise RuntimeError(f"gathered {tuple(t.shape)}, expected {tuple(sh.shape)} "
                               f"(spec {sh.spec})")
        return t

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist
        sh = ctx.sh
        for dim, a in reversed(sh._steps()):
            n, group = axis_sizes(sh.mesh)[a], sh.mesh.get_group(a)
            if a in BATCH_AXES and ctx.rows_split:
                parts = [c.contiguous() for c in g.chunk(n, dim)]
                out = torch.empty_like(parts[0])
                dist.reduce_scatter(out, parts, group=group)
                g = out
            else:
                g = g.narrow(dim, sh.mesh.get_local_rank(a) * (g.shape[dim] // n),
                             g.shape[dim] // n)
        return g, None


def mesh_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names (None: none)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def unshard(x):
    """The whole tensor of a ``Sharded`` (gathered), anything else as is."""
    return x.full() if isinstance(x, Sharded) else x


def local_of(x):
    """This rank's block of a ``Sharded`` (the tensor that trains), anything
    else as is."""
    return x.local if isinstance(x, Sharded) else x


def distribute(t: torch.Tensor, spec: Tuple, mesh) -> Sharded:
    """The layout step: this rank's block of ``t`` under ``spec`` (as
    ``constrained_sharding`` returns it: every named axis divides its dim).
    A block smaller than the whole is copied out, so the whole can be
    freed; a whole block is ``t`` itself."""
    sizes, local = axis_sizes(mesh), t
    for dim, entry in enumerate(spec):
        axes = mesh_axes(entry)
        n = math.prod(sizes[a] for a in axes)
        if n == 1:
            continue
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + mesh.get_local_rank(a)
        step = t.shape[dim] // n
        local = local.narrow(dim, idx * step, step)
    if local.shape != t.shape:
        local = local.clone()
    return Sharded(local, spec, t.shape, mesh)


def lay_out(t: torch.Tensor, pspec, mesh):
    """``t`` laid out on ``mesh`` by ``pspec`` after the divisibility snap:
    a ``Sharded`` when an axis survives, else ``t`` itself (a replicated
    leaf stays a plain tensor, so code that reads it directly needs no
    gather)."""
    spec = constrained_sharding(mesh, pspec, t.shape)
    return distribute(t, spec, mesh) if any(e is not None for e in spec) else t


def lay_out_as(t: torch.Tensor, like):
    """``t`` laid out as ``like`` is (a ``Sharded`` of the same shape), or
    ``t`` itself when ``like`` is a plain tensor."""
    return distribute(t, like.spec, like.mesh) if isinstance(like, Sharded) else t


def placement_pspec(placement: Optional[LayerPlacement], leaf: str, ndim: int) -> Tuple:
    """The spec (one mesh axis or None a dim) of one layer-subdict leaf
    under a LayerPlacement.

    The last two dims of E / W / Eq are (rows, cols): they map to
    (row_axis, col_axis); leading dims replicate.  The per-block Es/Ez
    scale grids follow the codes only when ``scales == 'shard'``; a bias
    shards its single (cols) dim.  Anything else replicates."""
    if placement is None:
        return (None,) * ndim
    row, col = placement.row_axis, placement.col_axis
    if leaf in ("E", "W", "Eq") and ndim >= 2:
        return (None,) * (ndim - 2) + (row, col)
    if leaf in ("Es", "Ez") and ndim >= 2 and placement.scales == "shard":
        return (None,) * (ndim - 2) + (row, col)
    if leaf == "b" and ndim >= 1:
        return (None,) * (ndim - 1) + (col,)
    return (None,) * ndim


def constrained_sharding(mesh, pspec, shape) -> Tuple:
    """``pspec`` with axes dropped when absent from the mesh (a
    ``DeviceMesh`` or a {axis: size} dict) or when they do not divide the
    dim: the divisibility snap the placement legalizer applies to plans,
    enforced again at the tensor layer so a stale annotation degrades to
    replicated instead of failing the layout."""
    sizes = axis_sizes(mesh)
    fixed = []
    for i, entry in enumerate(pspec):
        axes = tuple(a for a in mesh_axes(entry) if a in sizes)
        ok = axes and shape[i] % math.prod(sizes[a] for a in axes) == 0
        fixed.append((axes if len(axes) > 1 else axes[0]) if ok else None)
    return tuple(fixed)


def _place_layer(leaves: dict, cfg: EpLayerConfig, mesh) -> dict:
    """Lay one (possibly prepacked) layer subdict out on ``mesh`` by its
    config's placement record.  Layers without one pass through untouched
    (the caller's fallback specs own them)."""
    if cfg.placement is None:
        return leaves
    return {k: lay_out(v, placement_pspec(cfg.placement, k, v.ndim), mesh)
            for k, v in leaves.items()}


def prepack_tree(params, layer_configs: Mapping[str, EpLayerConfig], prefix: str = "",
                 mesh=None):
    """Tree variant of ``prepack_linear`` for the LM's nested parameter dicts.

    Walks ``params`` and packs every linear-layer subdict whose '/'-joined
    path (under ``prefix``) names a kernel x quant epitome entry of
    ``layer_configs``; everything else passes through untouched.  The port
    keeps one dict per group rather than stacking leaves over a group axis,
    so nothing is vmapped: the caller walks each group with prefix "".

    With ``mesh``, every layer subdict named by ``layer_configs`` is also
    laid out by its placement record (``_place_layer``): the packed int8
    codes land as this rank's blocks as they are made."""
    if not isinstance(params, dict):
        return params
    if "E" in params or "W" in params:       # a linear/conv layer subdict
        cfg = layer_configs.get(prefix)
        if cfg is None:
            return params
        out = prepack_linear(params, cfg)
        return out if mesh is None else _place_layer(out, cfg, mesh)
    return {k: prepack_tree(v, layer_configs, f"{prefix}/{k}" if prefix else k, mesh)
            for k, v in params.items()}


def param_count(params) -> int:
    """Elements in a parameter tree (dicts and lists; a laid-out leaf
    counts whole)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return math.prod(params.shape)


def exact_dot(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``x @ W.to(x.dtype)`` as the reference's ``exact_dot`` computes it:
    for a compute dtype narrower than float32, both operands are rounded to
    it, multiplied in float32 and the product rounded once; float32 (and
    wider) takes the plain product."""
    if x.dtype.is_floating_point and torch.finfo(x.dtype).bits < 32:
        Wb = W.to(x.dtype)
        return (x.to(torch.float32) @ Wb.to(torch.float32)).to(x.dtype)
    return x @ W.to(x.dtype)


def _whole(params: dict) -> dict:
    """A layer subdict with its laid-out leaves gathered (``Sharded``):
    the layer computes on exactly the tensors one card holds, so a sharded
    model's outputs are the one-card model's bit for bit."""
    if not any(isinstance(v, Sharded) for v in params.values()):
        return params
    return {k: unshard(v) for k, v in params.items()}


def apply_linear(params: dict, x: torch.Tensor, cfg: EpLayerConfig) -> torch.Tensor:
    """y = x @ W (+ b), with W possibly epitome-backed and quantized.  Leaves
    laid out on a mesh are gathered first (``_whole``)."""
    params = _whole(params)
    if not cfg.is_epitome:
        W = params["W"]
        if cfg.quant is not None:
            W = fake_quant(W, None, cfg.quant)
        y = exact_dot(x, W)
    else:
        y = _dispatch_epitome_matmul(params, x, cfg)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Conv2D (NHWC) — for the paper's own ResNet-50/101 evaluation
# ---------------------------------------------------------------------------
def init_conv(generator: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              cfg: EpLayerConfig, dtype=torch.float32, device="cuda") -> dict:
    """An epitome {"E"} or a dense HWIO {"W"}, drawn on the CPU from
    ``generator``."""
    if cfg.is_epitome:
        return {"E": init_epitome(generator, cfg.spec, dtype=dtype, device=device)}
    W = torch.randn((kh, kw, cin, cout), generator=generator) / math.sqrt(kh * kw * cin)
    return {"W": W.to(device=device, dtype=dtype)}


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding of one spatial dim: out = ceil(size / stride)
    and the total pad split with the extra element at the end, e.g. (2, 3)
    for a 7x7 stride-2 conv on 224 and (0, 1) for 3x3 stride 2 on 56 —
    which a symmetric ``padding=`` cannot express."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_nchw(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str,
             value: float = 0.0) -> torch.Tensor:
    """Apply 'SAME' or 'VALID' padding to an NCHW tensor explicitly."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    hlo, hhi = same_pads(x.shape[2], kh, stride)
    wlo, whi = same_pads(x.shape[3], kw, stride)
    if hlo or hhi or wlo or whi:
        x = F.pad(x, (wlo, whi, hlo, hhi), value=value)
    return x


def im2col(x: torch.Tensor, kh: int, kw: int, *, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """Extract conv patches as matmul rows: (N, H, W, cin) ->
    (N, H', W', kh*kw*cin), the im2col matrix of the PIM mapping [13].

    Feature columns are ordered (kh, kw, cin), as in the reference, to match
    an HWIO weight flattened to (kh*kw*cin, cout) and EpitomeSpec.M's row
    order.  (``F.unfold`` would give (cin, kh, kw).)"""
    xp = pad_nchw(x.permute(0, 3, 1, 2), kh, kw, stride, padding).permute(0, 2, 3, 1)
    N, Hp, Wp, cin = xp.shape
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    cols = [xp[:, i:i + stride * (Ho - 1) + 1:stride,
               j:j + stride * (Wo - 1) + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    if len(cols) == 1:
        return cols[0]
    return torch.stack(cols, dim=3).reshape(N, Ho, Wo, kh * kw * cin)


def apply_conv(params: dict, x: torch.Tensor, kh: int, kw: int, cin: int,
               cout: int, cfg: EpLayerConfig, *, stride: int = 1,
               padding: str = "SAME") -> torch.Tensor:
    """Conv in crossbar space (NHWC in and out).  Epitomized convs outside
    'reconstruct' lower to the im2col patch matrix and run the ladder of
    ``_dispatch_epitome_matmul``, folding each patch row into epitome rows
    once (the IFRT reuse).  Dense convs and 'reconstruct' run one
    convolution (cuDNN on the card), as the reference runs XLA's."""
    params = _whole(params)
    if cfg.is_epitome and cfg.mode != "reconstruct":
        patches = im2col(x, kh, kw, stride=stride, padding=padding)
        return _dispatch_epitome_matmul(params, patches, cfg)
    if cfg.is_epitome:
        E = params["E"]
        if cfg.quant is not None:
            E = fake_quant(E, cfg.spec, cfg.quant)
        W = reconstruct(E, cfg.spec).reshape(kh, kw, cin, cout)
    else:
        W = params["W"]
        if cfg.quant is not None:
            W = fake_quant(W.reshape(-1, cout), None, cfg.quant).reshape(kh, kw, cin, cout)
    xp = pad_nchw(x.permute(0, 3, 1, 2), kh, kw, stride, padding)
    y = F.conv2d(xp, W.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)
