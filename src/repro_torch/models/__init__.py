"""The paper's ResNet benchmark networks and the LM (counterparts of
``repro.models``): ``resnet``, and ``config``/``common``/``attention``/
``ssm``/``moe``/``blocks``/``lm`` for the language models (the attention
and RWKV6 kinds, the dense and MoE FFNs; Mamba comes with a later slice)."""
from .resnet import ResNetModel, resnet50, resnet101, tiny_resnet
