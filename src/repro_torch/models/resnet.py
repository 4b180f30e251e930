"""ResNet-50/101 in PyTorch — the paper's own benchmark networks.

Layer geometry comes from the ``pim.workloads`` inventories, as in
``repro.models.resnet``.  Convolutions are epitomized in crossbar space
(rows = kh*kw*cin, cols = cout) and run through the layers' execution
ladder via their im2col patch matrix — with mode="kernel" and 3-bit quant,
every epitomized conv is one launch of the fused int8 kernel.

Deployment designs arrive as ``pim.plan.EpitomePlan`` artifacts:
``ResNetModel.from_plan`` builds exactly the plan's per-layer specs, bits
and tuned blocks.

The public layout is NHWC, as the reference's: ``apply`` takes
(N, H, W, 3) images.  BatchNorm uses batch statistics with the population
variance.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.epitome import EpitomeSpec
from ..core.layers import (EpLayerConfig, apply_conv, apply_linear, init_conv,
                           init_linear, pad_nchw, prepack_linear)
from ..core.quant import QuantConfig
from ..pim.plan import EpitomePlan, inventory_for, plan_conv_specs
from ..pim.workloads import (LayerShape, resnet50_layers, resnet101_layers,
                             tiny_resnet_layers)

_PARAMETERS = ("E", "W", "b", "bn_g", "bn_b")   # the rest (Eq/Es/Ez) are buffers


def module_key(name: str) -> str:
    """``nn.ModuleDict`` rejects '.', which every inventory name but conv1
    and fc holds; the names have no '_', so the map is reversible."""
    return name.replace(".", "_")


class _Leaves(nn.Module):
    """One layer's tensors under the reference's leaf names, nested as its
    parameter tree is: float weights as parameters, the packed codes and
    their scales as buffers, sub-dicts as child modules."""

    def __init__(self, tree: Mapping[str, object]):
        super().__init__()
        self._names: List[str] = []
        for k, v in tree.items():
            self.put(k, v)

    def put(self, name: str, value) -> None:
        if name not in self._names:
            self._names.append(name)
        if isinstance(value, Mapping):
            self.add_module(name, _Leaves(value))
        elif name in _PARAMETERS:
            self.register_parameter(name, nn.Parameter(value))
        else:
            self.register_buffer(name, value)

    def tree(self) -> Dict[str, object]:
        return {k: (v.tree() if isinstance(v, _Leaves) else v)
                for k, v in ((k, getattr(self, k)) for k in self._names)}


def _ep_cfg(spec: Optional[EpitomeSpec], quant_bits: int, mode: str,
            blocks: Optional[Tuple[int, int, int]] = None,
            fused_fold: bool = False) -> EpLayerConfig:
    q = QuantConfig(bits=quant_bits) if quant_bits else None
    return EpLayerConfig(spec=spec, mode=mode, quant=q, blocks=blocks,
                         fused_fold=fused_fold)


class ResNetModel(nn.Module):
    """ResNet built from a LayerShape inventory.

    ``quant_bits`` is an int (uniform) or a per-layer sequence; 0/None
    entries mean fp weights.  ``tuned`` maps a layer name to its
    ((bt, bk, bn) or None, fused_fold) pair.  Parameters are made by
    ``init`` (from a seed) or ``load_params`` (e.g. from
    ``convert.params_from_jax``); ``prepack`` adds the int8 codes."""

    def __init__(self, layers: Sequence[LayerShape],
                 specs: Optional[Sequence[Optional[EpitomeSpec]]] = None,
                 quant_bits: Union[int, Sequence[Optional[int]]] = 0,
                 mode: str = "reconstruct",
                 tuned: Optional[Mapping[str, Tuple[Optional[Tuple[int, int, int]],
                                                    bool]]] = None,
                 num_classes: int = 0, device="cuda"):
        super().__init__()
        self.layers = list(layers)
        self._by_name = {l.name: l for l in self.layers}
        self.specs = list(specs) if specs is not None else [None] * len(self.layers)
        if isinstance(quant_bits, (list, tuple)):
            if len(quant_bits) != len(self.layers):
                raise ValueError(f"{len(quant_bits)} quant_bits entries for "
                                 f"{len(self.layers)} layers")
            self.layer_bits = [int(b) if b else 0 for b in quant_bits]
        else:
            self.layer_bits = [int(quant_bits or 0)] * len(self.layers)
        self.mode = mode
        self.tuned = dict(tuned) if tuned else {}
        self.num_classes = num_classes or self.layers[-1].cout
        self.device = torch.device(device)
        self.cfgs = {}
        for l, s, b in zip(self.layers, self.specs, self.layer_bits):
            blocks, fused = self.tuned.get(l.name, (None, False))
            self.cfgs[l.name] = _ep_cfg(s, b, mode, blocks=blocks, fused_fold=fused)
        self.net = nn.ModuleDict()
        names = [l.name for l in self.layers if l.name not in ("conv1", "fc")]
        self._blocks: List[str] = sorted({n.rsplit(".", 1)[0] for n in names},
                                         key=lambda b: names.index(b + ".conv1"))

    @classmethod
    def from_plan(cls, plan: EpitomePlan, **kw) -> "ResNetModel":
        """Build the model an EpitomePlan describes: specs, weight bits,
        mode and tuned kernel blocks exactly as the plan records them (the
        execute end of the plan -> legalize -> execute pipeline)."""
        layers = inventory_for(plan.arch)()
        names = [l.name for l in layers]
        got = [lp.name for lp in plan.layers]
        if names != got:
            raise ValueError(f"plan layers {got} do not match the "
                             f"{plan.arch} inventory {names}")
        return cls(layers, plan.specs(), quant_bits=plan.bits(),
                   mode=plan.uniform_mode(), tuned=plan.tuned_blocks(), **kw)

    # -- parameters ----------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             dtype=torch.float32) -> "ResNetModel":
        """Draw every layer's weights, in inventory order, from ``generator``
        (a CPU generator; default seed 0) and place them on the device."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        params = {}
        for l in self.layers:
            cfg = self.cfgs[l.name]
            if l.kind == "fc":
                params[l.name] = init_linear(gen, l.rows, l.cols, cfg,
                                             dtype=dtype, device=self.device)
            else:
                params[l.name] = {
                    "conv": init_conv(gen, l.kh, l.kw, l.cin, l.cout, cfg,
                                      dtype, device=self.device),
                    "bn_g": torch.ones((l.cout,), dtype=dtype, device=self.device),
                    "bn_b": torch.zeros((l.cout,), dtype=dtype, device=self.device),
                }
        return self.load_params(params)

    def load_params(self, params: Mapping[str, Mapping]) -> "ResNetModel":
        """Take a parameter tree keyed by inventory name, nested as the
        reference's ({name: {"conv": {"E"|"W", ...}, "bn_g", "bn_b"}, "fc":
        {"E"|"W", ...}})."""
        self.net = nn.ModuleDict({module_key(l.name): _Leaves(params[l.name])
                                  for l in self.layers})
        return self

    def params(self) -> Dict[str, Dict]:
        """The parameter tree, keyed and nested as ``load_params`` takes it."""
        return {l.name: self.net[module_key(l.name)].tree() for l in self.layers}

    def prepack(self) -> "ResNetModel":
        """Inference prepack for weight-stationary serving: every kernel x
        quant epitome layer, fc and conv, is quantized once (int8 codes +
        per-block scale/zero) so apply feeds the fused kernel stored codes.
        No-op for other modes."""
        for l in self.layers:
            leaves = self.net[module_key(l.name)]
            target = leaves if l.kind == "fc" else leaves.conv
            packed = prepack_linear(target.tree(), self.cfgs[l.name])
            for k in ("Eq", "Es", "Ez"):
                if k in packed:
                    target.put(k, packed[k])
        return self

    # -- forward -------------------------------------------------------------
    def _conv_bn(self, name: str, x: torch.Tensor, act: bool = True) -> torch.Tensor:
        l = self._by_name[name]
        p = self.net[module_key(name)].tree()
        y = apply_conv(p["conv"], x, l.kh, l.kw, l.cin, l.cout, self.cfgs[name],
                       stride=l.stride, padding="SAME")
        mean = y.mean(dim=(0, 1, 2))
        var = y.var(dim=(0, 1, 2), unbiased=False)
        y = (y - mean) * torch.rsqrt(var + 1e-5) * p["bn_g"] + p["bn_b"]
        return F.relu(y) if act else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, 3) -> logits (N, num_classes)."""
        x = self._conv_bn("conv1", x)
        # 3x3 stride-2 'SAME' max-pool: -inf padding, extra element at the end
        x = pad_nchw(x.permute(0, 3, 1, 2), 3, 3, 2, "SAME", value=float("-inf"))
        x = F.max_pool2d(x, 3, 2).permute(0, 2, 3, 1)
        for b in self._blocks:
            residual = x
            h = self._conv_bn(f"{b}.conv1", x)
            h = self._conv_bn(f"{b}.conv2", h)
            h = self._conv_bn(f"{b}.conv3", h, act=False)
            if f"{b}.down" in self.cfgs:
                residual = self._conv_bn(f"{b}.down", residual, act=False)
            x = F.relu(h + residual)
        x = x.mean(dim=(1, 2))                        # global average pool
        return apply_linear(self.net["fc"].tree(), x, self.cfgs["fc"])

    def apply(self, x):
        """Logits for images x, as the reference's ``apply``; given a
        callable instead, applies it to every submodule as
        ``nn.Module.apply`` does."""
        if callable(x) and not isinstance(x, torch.Tensor):
            return super().apply(x)
        return self(x)


def resnet50(specs=None, **kw) -> ResNetModel:
    return ResNetModel(resnet50_layers(), specs, **kw)


def resnet101(specs=None, **kw) -> ResNetModel:
    return ResNetModel(resnet101_layers(), specs, **kw)


def tiny_resnet(specs="auto", **kw) -> ResNetModel:
    """Reduced same-family network for CPU tests: conv1 + 2 bottlenecks.
    ``specs="auto"`` plans small (8, 8)-patch kernel-exact epitomes for
    every layer; ``specs=None`` gives a dense model."""
    layers = tiny_resnet_layers()
    if isinstance(specs, str) and specs == "auto":
        specs = plan_conv_specs(layers, target_cr=2.0, patch=(8, 8))
    return ResNetModel(layers, specs, **kw)
