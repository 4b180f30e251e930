"""The ten architectures of the reference, their published configs (a copy
of ``repro.configs.archs``: the builders are data).

Sources: rwkv6 [arXiv:2404.05892], phi3.5-moe
[hf:microsoft/Phi-3.5-MoE-instruct], grok-1 [hf:xai-org/grok-1], jamba-1.5
[arXiv:2403.19887], qwen2-72b [arXiv:2407.10671], qwen1.5-110b [hf:Qwen],
gemma2-2b [arXiv:2408.00118], deepseek-67b [arXiv:2401.02954], musicgen-large
[arXiv:2306.05284], internvl2-76b [arXiv:2404.16821].
"""
from __future__ import annotations

from ..models.config import EpitomeSettings, ModelConfig


def rwkv6_7b(ep: EpitomeSettings) -> ModelConfig:
    # Finch 7B: attention-free, data-dependent decay; head size 64
    return ModelConfig(
        name="rwkv6-7b", n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab=65536,
        pattern=("rwkv",), ffn_pattern=("rwkv_ffn",),
        epitome=ep)


def phi35_moe(ep: EpitomeSettings) -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=6400, vocab=32064,
        pattern=("attn",), ffn_pattern=("moe",),
        n_experts=16, top_k=2,
        epitome=ep)


def grok_1(ep: EpitomeSettings) -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=32768, vocab=131072,
        pattern=("attn",), ffn_pattern=("moe",),
        n_experts=8, top_k=2,
        epitome=ep)


def jamba_15_large(ep: EpitomeSettings) -> ModelConfig:
    # Mamba+attention 1:7 interleave, MoE every other layer
    return ModelConfig(
        name="jamba-1.5-large-398b", n_layers=72, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=24576, vocab=65536,
        pattern=("mamba", "mamba", "mamba", "mamba",
                 "attn", "mamba", "mamba", "mamba"),
        ffn_pattern=("dense", "moe", "dense", "moe",
                     "dense", "moe", "dense", "moe"),
        n_experts=16, top_k=2,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        epitome=ep)


def qwen2_72b(ep: EpitomeSettings) -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=29568, vocab=152064, qkv_bias=True,
        pattern=("attn",), ffn_pattern=("dense",),
        epitome=ep)


def qwen15_110b(ep: EpitomeSettings) -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=49152, vocab=152064, qkv_bias=True,
        pattern=("attn",), ffn_pattern=("dense",),
        epitome=ep)


def gemma2_2b(ep: EpitomeSettings) -> ModelConfig:
    # local(4k window)/global alternating, logit softcap 30, attn softcap 50
    return ModelConfig(
        name="gemma2-2b", n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        d_ff=9216, vocab=256000, head_dim=256,
        pattern=("attn_local", "attn"), ffn_pattern=("dense", "dense"),
        window=4096, attn_softcap=50.0, logit_softcap=30.0,
        act="gelu", tie_embeddings=True,
        epitome=ep)


def deepseek_67b(ep: EpitomeSettings) -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=22016, vocab=102400,
        pattern=("attn",), ffn_pattern=("dense",),
        epitome=ep)


def musicgen_large(ep: EpitomeSettings) -> ModelConfig:
    # decoder-only over EnCodec tokens; the EnCodec frontend is a STUB:
    # input_specs supplies precomputed frame embeddings
    return ModelConfig(
        name="musicgen-large", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab=2048,
        pattern=("attn",), ffn_pattern=("dense",),
        embed_inputs=True,
        epitome=ep)


def internvl2_76b(ep: EpitomeSettings) -> ModelConfig:
    # InternViT frontend is a STUB (patch embeddings supplied); this is the
    # InternLM2-78B-style language backbone
    return ModelConfig(
        name="internvl2-76b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=28672, vocab=128256,
        pattern=("attn",), ffn_pattern=("dense",),
        embed_inputs=True,
        epitome=ep)


BUILDERS = {
    "rwkv6-7b": rwkv6_7b,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "grok-1-314b": grok_1,
    "jamba-1.5-large-398b": jamba_15_large,
    "qwen2-72b": qwen2_72b,
    "qwen1.5-110b": qwen15_110b,
    "gemma2-2b": gemma2_2b,
    "deepseek-67b": deepseek_67b,
    "musicgen-large": musicgen_large,
    "internvl2-76b": internvl2_76b,
}
