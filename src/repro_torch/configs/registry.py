"""Named epitome variants and the model registry (counterpart of
``repro.configs.registry``): ``get_resnet`` for the paper's ResNets,
``get_config``/``get_smoke_config`` for the ten LM architectures."""
from __future__ import annotations

import dataclasses
import functools

from ..models.config import EpitomeSettings, ModelConfig
from .archs import BUILDERS

ARCHS = tuple(BUILDERS)


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


@functools.lru_cache(maxsize=None)
def _evo_variant(arch: str, epitome: str):
    """Plan-pipeline registry names: ``evo-<objective>[-q<bits>]`` (e.g.
    ``evo-latency-q3``) runs the Algorithm-1 search, legalizes the result
    to the kernel-exact families, and returns that plan.  Cached: the
    search is deterministic under its fixed seed."""
    from ..pim.evo import EvoConfig
    from ..pim.plan import legalize_plan, search_plan
    parts = epitome[len("evo-"):].split("-")
    bits = None
    if parts and parts[-1].startswith("q") and parts[-1][1:].isdigit():
        bits = int(parts.pop()[1:])
    objective = "-".join(parts)
    if objective not in ("latency", "energy", "edp"):
        raise KeyError(f"unknown evo variant {epitome!r} "
                       "(expected evo-{latency|energy|edp}[-q<bits>])")
    plan = search_plan(arch, objective=objective, weight_bits=bits,
                       act_bits=9 if bits else None,
                       evo=EvoConfig(population=16, iterations=8, seed=0))
    return legalize_plan(plan)


def _load_plan(plan, expected_arch: str):
    """An EpitomePlan, or one loaded from a saved plan JSON path, checked
    to target ``expected_arch``."""
    from ..pim.plan import EpitomePlan
    if isinstance(plan, str):
        plan = EpitomePlan.load(plan)
    if plan.arch != expected_arch:
        raise ValueError(f"plan is for {plan.arch!r}, requested {expected_arch!r}")
    return plan


RESNET_ARCHS = ("tiny-resnet", "resnet50", "resnet101")


def get_resnet(arch: str = "tiny-resnet", epitome: str = "off", plan=None, *,
               device="cuda", **kw):
    """ResNetModel wired to a named epitome variant — ``get_resnet(
    "resnet50", "kernel-q3")`` is the paper's flagship EPIM-ResNet: every
    epitomized conv lowers to im2col and runs the fused int8 kernel.
    tiny-resnet plans (8, 8) patches at CR 2 so its reduced layers still
    epitomize; the full networks use crossbar-sized (256, 256) patches at
    the variant's target CR.  Other keywords (``tuned=``) go to
    ResNetModel.

    Plan pipeline entry points: ``plan=`` (an EpitomePlan or a saved plan
    JSON path) builds exactly that design, and ``epitome="evo-latency-q3"``
    etc. build the searched and legalized design (``_evo_variant``)."""
    from ..models.resnet import ResNetModel, resnet50, resnet101, tiny_resnet
    from ..pim.plan import plan_conv_specs
    from ..pim.workloads import (resnet50_layers, resnet101_layers,
                                 tiny_resnet_layers)
    if plan is not None:
        return ResNetModel.from_plan(_load_plan(plan, arch), device=device, **kw)
    if epitome.startswith("evo-"):
        return ResNetModel.from_plan(_evo_variant(arch, epitome), device=device, **kw)
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


def _plan_layer_config(plan, expected_arch: str):
    """Load and check an LM EpitomePlan for ``ModelConfig.layer_config``.
    Kernel-mode specs must be kernel-exact (bn-aligned): a searched but
    unlegalized plan would sample snapped, inexact geometry in the fused
    kernels, so it is refused with a pointer at the legalizer."""
    from ..pim.plan import is_kernel_exact
    plan = _load_plan(plan, expected_arch)
    for lp in plan.layers:
        if lp.spec is not None and lp.mode == "kernel" \
                and not is_kernel_exact(lp.spec):
            raise ValueError(
                f"plan layer {lp.name!r} spec is not kernel-exact; run "
                f"`python -m repro_torch.launch.plan legalize` before "
                f"building a model from it")
    return plan.layer_configs()


def get_config(arch: str, epitome: str = "off", plan=None,
               **overrides) -> ModelConfig:
    """The full published config of ``arch`` with a named epitome variant;
    ``overrides`` replace fields (e.g. ``compute_dtype="float32"``,
    ``n_layers=2``).  ``plan`` (an EpitomePlan or plan JSON path for this
    arch) installs per-layer {spec, bits, mode} through
    ``ModelConfig.layer_config``; the variant then governs only layers the
    plan does not name."""
    cfg = BUILDERS[arch](epitome_settings(epitome))
    if plan is not None:
        cfg = dataclasses.replace(cfg, layer_config=_plan_layer_config(plan, arch))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(arch: str, epitome: str = "off",
                     plan=None) -> ModelConfig:
    """Reduced same-family config: two super-block repeats, narrow dims,
    with small epitomes still planned (min_params 0, CR 2, 32 x 32
    patches).  ``plan`` must target the matching '<arch>-smoke' plan
    arch."""
    full = get_config(arch, epitome)
    ep = epitome_settings(epitome)
    if ep.enabled:
        ep = dataclasses.replace(ep, min_params=0, target_cr=2.0, patch=(32, 32))
    layer_config = ()
    if plan is not None:
        layer_config = _plan_layer_config(plan, f"{arch}-smoke")
    return dataclasses.replace(
        full,
        layer_config=layer_config,
        n_layers=2 * len(full.pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(full.n_kv_heads, 2),
        head_dim=16 if full.head_dim else 0,
        d_ff=96,
        vocab=192,
        n_experts=min(full.n_experts, 4) if full.n_experts else 0,
        window=8,
        rwkv_lora_decay=8, rwkv_lora_mix=4,
        mamba_d_state=4, mamba_d_conv=4, mamba_expand=2,
        epitome=ep,
    )
