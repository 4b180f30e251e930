"""The paper's ResNet benchmark networks and the LM (counterparts of
``repro.models``): ``resnet``, and ``config``/``common``/``attention``/
``ssm``/``blocks``/``lm`` for the language models (the attention and RWKV6
kinds; MoE and Mamba come with later slices)."""
from .resnet import ResNetModel, resnet50, resnet101, tiny_resnet
