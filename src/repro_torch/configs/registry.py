"""Named epitome variants and the ResNet registry (counterpart of the
non-LM part of ``repro.configs.registry``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EpitomeSettings:
    """The fields of the reference's ``EpitomeSettings`` that the ResNet
    registry reads."""
    enabled: bool = False
    target_cr: float = 4.0            # weight-matrix compression rate
    mode: str = "folded"              # reconstruct | wrapped | folded | kernel
    quant_bits: int = 0               # 0 = fp; else epitome-aware quant


def epitome_settings(variant: str) -> EpitomeSettings:
    """Named epitome variants:
    off          — dense baseline
    paper        — reconstruct W from the epitome (storage compression only)
    wrapped      — + output channel wrapping (§5.3)
    folded       — epitome-space matmul (FLOPs and bytes / CR)
    folded-q3    — folded + 3-bit epitome-aware fake quant
    kernel       — the epitome matmul kernel
    kernel-q3    — the fused int8 quantized-epitome kernel at 3 bits: the
                   paper's flagship EPIM configuration (inference-only)
    """
    return {
        "off": EpitomeSettings(enabled=False),
        "paper": EpitomeSettings(enabled=True, mode="reconstruct"),
        "wrapped": EpitomeSettings(enabled=True, mode="wrapped"),
        "folded": EpitomeSettings(enabled=True, mode="folded"),
        "folded-q3": EpitomeSettings(enabled=True, mode="folded", quant_bits=3),
        "kernel": EpitomeSettings(enabled=True, mode="kernel"),
        "kernel-q3": EpitomeSettings(enabled=True, mode="kernel", quant_bits=3),
    }[variant]


RESNET_ARCHS = ("tiny-resnet", "resnet50", "resnet101")


def get_resnet(arch: str = "tiny-resnet", epitome: str = "off", plan=None, *,
               device="cuda", **kw):
    """ResNetModel wired to a named epitome variant — ``get_resnet(
    "resnet50", "kernel-q3")`` is the paper's flagship EPIM-ResNet: every
    epitomized conv lowers to im2col and runs the fused int8 kernel.
    tiny-resnet plans (8, 8) patches at CR 2 so its reduced layers still
    epitomize; the full networks use crossbar-sized (256, 256) patches at
    the variant's target CR.  Other keywords (``tuned=``) go to
    ResNetModel."""
    from ..models.resnet import resnet50, resnet101, tiny_resnet
    from ..pim.plan import plan_conv_specs
    from ..pim.workloads import (resnet50_layers, resnet101_layers,
                                 tiny_resnet_layers)
    if plan is not None or epitome.startswith("evo-"):
        raise NotImplementedError(
            "plan-driven models (plan=, evo-* variants) come with slice 2 of "
            "the port: the EpitomePlan stack is not ported yet")
    build, inventory = {
        "tiny-resnet": (tiny_resnet, tiny_resnet_layers),
        "resnet50": (resnet50, resnet50_layers),
        "resnet101": (resnet101, resnet101_layers),
    }[arch]
    ep = epitome_settings(epitome)
    if not ep.enabled:
        return build(specs=None, device=device, **kw)
    cr, patch = ((2.0, (8, 8)) if arch == "tiny-resnet"
                 else (ep.target_cr, (256, 256)))
    specs = plan_conv_specs(inventory(), target_cr=cr, patch=patch)
    return build(specs, quant_bits=ep.quant_bits, mode=ep.mode, device=device, **kw)
