"""LM configuration (counterpart of ``repro.models.config``).

A model is ``n_layers`` layers; layers cycle through ``pattern`` (the
smallest repeating "super-block", e.g. jamba's 1-attention-per-8 or gemma2's
local/global alternation).  Each pattern position names a sequence mixer and
an FFN kind.  The fields, their defaults and the per-site epitome
resolution (``ModelConfig.ep``) are the reference's; ``pdtype``/``cdtype``
are torch dtypes.  Of the reference's distribution knobs the port keeps
``moe_decode_dispatch`` (the MoE FFN's all_to_all dispatch at decode on a
mesh), ``remat_policy`` (what the training forward keeps of each group)
and ``kv_cache_bits`` (the int8 KV cache of the attention kinds);
``seq_shard_residual`` (a sharding constraint on the residual) has no
counterpart: the port's activations are whole on every rank.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import warnings
from typing import Optional, Tuple

import torch

from ..core.epitome import EpitomeSpec, plan_epitome
from ..core.layers import EpLayerConfig
from ..core.quant import QuantConfig


class LayerKind(str, enum.Enum):
    ATTN = "attn"                 # global causal attention
    ATTN_LOCAL = "attn_local"     # sliding-window attention
    MAMBA = "mamba"
    RWKV = "rwkv"


@dataclasses.dataclass(frozen=True)
class EpitomeSettings:
    """How the paper's operator is applied across a model's weights."""
    enabled: bool = False
    target_cr: float = 4.0            # weight-matrix compression rate
    mode: str = "folded"              # reconstruct | wrapped | folded | kernel
    min_params: int = 1 << 22         # don't epitomize small matrices (4M)
    patch: Tuple[int, int] = (256, 256)
    quant_bits: int = 0               # 0 = fp; else epitome-aware quant
    quant_per_crossbar: bool = True
    quant_overlap_weighted: bool = True

    def layer_config(self, M: int, N: int) -> EpLayerConfig:
        if not self.enabled or M * N < self.min_params:
            return EpLayerConfig(spec=None, quant=self._qcfg())
        spec = plan_epitome(M, N, self.target_cr, patch=self.patch)
        if spec is not None and self.mode == "kernel":
            # the kernels' OFAT col-block table is exact only for the
            # bn-aligned families: snap the planned spec to one, and say so
            legal, err = _legalized(spec, M, N, self.patch)
            if legal != spec:
                warnings.warn(
                    f"epitome spec for ({M}, {N}) is not kernel-exact; "
                    f"snapped {spec.m}x{spec.n} -> "
                    f"{'dense' if legal is None else f'{legal.m}x{legal.n}'} "
                    f"(snap error {err:.3f})", stacklevel=2)
            spec = legal
        return EpLayerConfig(spec=spec, mode=self.mode, quant=self._qcfg())

    def _qcfg(self) -> Optional[QuantConfig]:
        if self.quant_bits <= 0:
            return None
        return QuantConfig(bits=self.quant_bits,
                           per_crossbar=self.quant_per_crossbar,
                           overlap_weighted=self.quant_overlap_weighted)


@functools.lru_cache(maxsize=None)
def _legalized(spec: EpitomeSpec, M: int, N: int, patch: Tuple[int, int]):
    """Snap an auto-planned spec to the kernel-exact families, returning
    (legal spec, snap error); warning-free, so the caller decides whether
    to surface the snap."""
    from ..pim.plan import is_kernel_exact, legalize_spec
    from ..pim.workloads import LayerShape
    if is_kernel_exact(spec):
        return spec, 0.0
    layer = LayerShape(f"{M}x{N}", 1, 1, M, N, 1, kind="fc")
    return legalize_spec(layer, spec, patch)


def layer_name(prefix: str, w: str) -> Optional[str]:
    """Param-tree path of projection ``w`` under ``prefix`` — the naming
    contract shared by pim.workloads.lm_layers, ModelConfig.layer_config and
    the tree prepack.  None without a prefix: the caller then resolves the
    layer's config by shape alone."""
    return f"{prefix}/{w}" if prefix else None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 -> d_model // n_heads

    # super-block structure
    pattern: Tuple[str, ...] = ("attn",)   # LayerKind values, cycled
    ffn_pattern: Tuple[str, ...] = ("dense",)  # dense | moe | none | rwkv_ffn, cycled

    # attention details
    qkv_bias: bool = False                 # qwen
    window: int = 4096                     # sliding window for ATTN_LOCAL
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0              # gemma2: 50.0
    logit_softcap: float = 0.0             # gemma2: 30.0

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_decode_dispatch: bool = False      # all_to_all dispatch even at decode
    router_jitter: float = 0.0

    # Mamba (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # RWKV6
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32

    # chunking
    attn_kv_chunk: int = 512
    rwkv_chunk: int = 64
    mamba_chunk: int = 128

    # what lm.forward(remat=True) keeps of each group for the backward:
    # nothing (recompute the group) | dots (keep the matmul outputs)
    remat_policy: str = "nothing"

    # KV cache of the attention kinds: 16 = the compute dtype, 8 = int8
    # codes with one fp16 scale per (token, head)
    kv_cache_bits: int = 16

    # misc
    act: str = "silu"                      # silu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # the paper's operator
    epitome: EpitomeSettings = EpitomeSettings()

    # per-layer epitome deployment keyed by param-tree path ("L0/mixer/wr",
    # ...); entries override ``epitome`` for their site.  A tuple of
    # (name, EpLayerConfig) pairs so the config stays hashable;
    # ``configs.get_config(plan=...)`` fills it from a plan.
    layer_config: Tuple[Tuple[str, EpLayerConfig], ...] = ()

    # modality frontend stub: inputs are precomputed embeddings
    embed_inputs: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not a "
                             f"multiple of pattern {len(self.pattern)}")
        if len(self.ffn_pattern) not in (1, len(self.pattern)):
            raise ValueError(f"{self.name}: ffn_pattern length mismatch")

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def full_pattern(self) -> Tuple[Tuple[str, str], ...]:
        fp = self.ffn_pattern * (len(self.pattern) // len(self.ffn_pattern)) \
            if len(self.ffn_pattern) == 1 else self.ffn_pattern
        return tuple(zip(self.pattern, fp))

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def ep(self, M: int, N: int, name: Optional[str] = None) -> EpLayerConfig:
        """EpLayerConfig for a weight of virtual shape (M, N).

        ``name`` is the layer's param-tree path; when it names an entry of
        ``layer_config`` that entry wins, otherwise the global
        EpitomeSettings plan the site from (M, N).  Resolved once per
        (config, site): the eager forward asks at every layer call, where
        the reference asks once per trace."""
        return _resolve(self, M, N, name)

    # -- parameter counting (the roofline's MODEL_FLOPS, 6 N D / 6 N_active D) ---
    def param_count(self, active_only: bool = False) -> int:
        """The reference's count, arithmetic for arithmetic: embedding and
        head, each layer's mixer and FFN (MoE: ``top_k`` experts when
        ``active_only``, the router always); the RWKV channel mix and the
        norms are not counted, as the reference counts neither."""
        d, ff, hd = self.d_model, self.d_ff, self.hd
        n = self.vocab * d  # embedding
        if not self.tie_embeddings:
            n += d * self.vocab
        for kind, ffn in self.full_pattern:
            reps = self.n_groups
            if kind in (LayerKind.ATTN.value, LayerKind.ATTN_LOCAL.value):
                n += reps * (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                             + self.n_heads * hd * d)
            elif kind == LayerKind.MAMBA.value:
                di, ds = self.mamba_d_inner, self.mamba_d_state
                n += reps * (d * 2 * di + di * self.mamba_d_conv
                             + di * (ds * 2 + di // 16 + ds) + di * d)
            elif kind == LayerKind.RWKV.value:
                n += reps * (4 * d * d + d * self.rwkv_lora_decay * 2
                             + 5 * d * self.rwkv_lora_mix * 2)
            if ffn == "moe":
                e = self.n_experts if not active_only else self.top_k
                n += reps * (e * 3 * d * ff + d * self.n_experts)
            elif ffn == "dense":
                mult = 3 if self.act in ("silu", "gelu") else 2
                n += reps * (mult * d * ff)
        return n


@functools.lru_cache(maxsize=None)
def _resolve(cfg: ModelConfig, M: int, N: int, name: Optional[str]) -> EpLayerConfig:
    if name is not None and cfg.layer_config:
        lc = dict(cfg.layer_config).get(name)
        if lc is not None:
            if lc.spec is not None and (lc.spec.M, lc.spec.N) != (M, N):
                raise ValueError(
                    f"{cfg.name}: plan spec for {name} covers "
                    f"({lc.spec.M}, {lc.spec.N}) but the layer is ({M}, {N})")
            return lc
    return cfg.epitome.layer_config(M, N)
