"""The paper's ResNet benchmark networks and the LM (counterparts of
``repro.models``): ``resnet``, and ``config``/``common``/``ssm``/``blocks``/
``lm`` for the language models (RWKV6 so far)."""
from .resnet import ResNetModel, resnet50, resnet101, tiny_resnet
