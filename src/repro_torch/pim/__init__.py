"""Layer inventories of the paper's benchmark networks and the kernel-exact
epitome spec designer (counterpart of the parts of ``repro.pim`` that the
ResNet path reads)."""
from .plan import is_kernel_exact, plan_conv_specs
from .workloads import (LayerShape, resnet50_layers, resnet101_layers,
                        tiny_resnet_layers)
