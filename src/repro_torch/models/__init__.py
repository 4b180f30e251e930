"""The paper's ResNet benchmark networks (counterpart of
``repro.models.resnet``)."""
from .resnet import ResNetModel, resnet50, resnet101, tiny_resnet
