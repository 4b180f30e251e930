"""Layer inventories of the paper's benchmark networks (crossbar space).

Every conv is described by its PIM mapping [13]: rows = c_in*kh*kw (word
lines), cols = c_out (bit lines), plus the output spatial size that sets the
number of crossbar activation rounds.  A copy of the ResNet and LM
inventories of ``repro.pim.workloads``, so the two packages build the same
networks.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class LayerShape:
    name: str
    kh: int
    kw: int
    cin: int
    cout: int
    out_hw: int          # output spatial edge (rounds = out_hw^2 for conv)
    stride: int = 1
    kind: str = "conv"   # conv | fc

    @property
    def rows(self) -> int:
        return self.cin * self.kh * self.kw

    @property
    def cols(self) -> int:
        return self.cout

    @property
    def params(self) -> int:
        return self.rows * self.cols

    @property
    def rounds(self) -> int:
        """Crossbar activation rounds for a dense conv (one per output px)."""
        return self.out_hw * self.out_hw if self.kind == "conv" else 1


def _bottleneck(layers: List[LayerShape], name: str, cin: int, width: int,
                cout: int, hw_in: int, stride: int, downsample: bool) -> int:
    hw_mid = hw_in            # 1x1 reduce keeps spatial size
    hw_out = hw_in // stride  # stride sits on the 3x3 (torchvision v1.5)
    layers.append(LayerShape(f"{name}.conv1", 1, 1, cin, width, hw_mid))
    layers.append(LayerShape(f"{name}.conv2", 3, 3, width, width, hw_out, stride))
    layers.append(LayerShape(f"{name}.conv3", 1, 1, width, cout, hw_out))
    if downsample:
        layers.append(LayerShape(f"{name}.down", 1, 1, cin, cout, hw_out, stride))
    return hw_out


def _resnet(block_counts: List[int]) -> List[LayerShape]:
    layers: List[LayerShape] = [LayerShape("conv1", 7, 7, 3, 64, 112, 2)]
    hw = 56  # after maxpool
    cin = 64
    widths = [64, 128, 256, 512]
    for si, (blocks, width) in enumerate(zip(block_counts, widths)):
        cout = width * 4
        for b in range(blocks):
            stride = 2 if (si > 0 and b == 0) else 1
            hw = _bottleneck(layers, f"layer{si+1}.{b}", cin, width, cout,
                             hw, stride, downsample=(b == 0))
            cin = cout
    layers.append(LayerShape("fc", 1, 1, 2048, 1000, 1, kind="fc"))
    return layers


def resnet50_layers() -> List[LayerShape]:
    return _resnet([3, 4, 6, 3])


def resnet101_layers() -> List[LayerShape]:
    return _resnet([3, 4, 23, 3])


def lm_layers(cfg) -> List[LayerShape]:
    """Per-super-block projection inventory of an LM config (crossbar space).

    ``cfg`` is duck-typed (a ``models.config.ModelConfig`` or anything with
    the same geometry attributes).  One LayerShape per attention/ffn
    projection site of the super-block, named exactly as the parameter tree
    path (``L{i}/mixer/wq``, ``L{i}/ffn/w_gate``, ...) so per-layer configs
    and the tree prepack key on the same names.  rows/cols are the
    projection's virtual (fan-in, fan-out); kind="fc".  Norms, LoRAs, mu's,
    conv buffers and stacked MoE expert tensors are not epitome sites."""
    d = cfg.d_model
    hd = cfg.head_dim or d // cfg.n_heads
    ff = cfg.d_ff
    fc = lambda name, rows, cols: LayerShape(name, 1, 1, rows, cols, 1,
                                             kind="fc")
    out: List[LayerShape] = []
    for i, (kind, ffn_kind) in enumerate(cfg.full_pattern):
        p = f"L{i}/mixer"
        if kind in ("attn", "attn_local"):
            out += [fc(f"{p}/wq", d, cfg.n_heads * hd),
                    fc(f"{p}/wk", d, cfg.n_kv_heads * hd),
                    fc(f"{p}/wv", d, cfg.n_kv_heads * hd),
                    fc(f"{p}/wo", cfg.n_heads * hd, d)]
        elif kind == "rwkv":
            out += [fc(f"{p}/{w}", d, d)
                    for w in ("wr", "wk", "wv", "wg", "wo")]
        elif kind == "mamba":
            di = cfg.mamba_expand * d
            ds = cfg.mamba_d_state
            dt_rank = max(1, d // 16)
            out += [fc(f"{p}/in_proj", d, 2 * di),
                    fc(f"{p}/x_proj", di, dt_rank + 2 * ds),
                    fc(f"{p}/dt_proj", dt_rank, di),
                    fc(f"{p}/out_proj", di, d)]
        q = f"L{i}/ffn"
        if ffn_kind == "dense":
            out += [fc(f"{q}/w_gate", d, ff), fc(f"{q}/w_up", d, ff),
                    fc(f"{q}/w_down", ff, d)]
        elif ffn_kind == "rwkv_ffn":
            out += [fc(f"{q}/wk", d, ff), fc(f"{q}/wv", ff, d),
                    fc(f"{q}/wr", d, d)]
    return out


def tiny_resnet_layers() -> List[LayerShape]:
    """Reduced same-family inventory for CPU tests: conv1 + 2 bottlenecks.

    models.resnet builds the matching model from it."""
    return [
        LayerShape("conv1", 3, 3, 3, 16, 16, 2),
        LayerShape("layer1.0.conv1", 1, 1, 16, 16, 16),
        LayerShape("layer1.0.conv2", 3, 3, 16, 16, 16),
        LayerShape("layer1.0.conv3", 1, 1, 16, 64, 16),
        LayerShape("layer1.0.down", 1, 1, 16, 64, 16),
        LayerShape("layer1.1.conv1", 1, 1, 64, 16, 16),
        LayerShape("layer1.1.conv2", 3, 3, 16, 16, 16),
        LayerShape("layer1.1.conv3", 1, 1, 16, 64, 16),
        LayerShape("fc", 1, 1, 64, 10, 1, kind="fc"),
    ]
