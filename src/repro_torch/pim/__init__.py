"""Layer inventories of the paper's benchmark networks and the kernel-exact
epitome spec designer (counterpart of the parts of ``repro.pim`` that the
ResNet and LM paths read)."""
from .plan import is_kernel_exact, legalize_spec, pack_grid, plan_conv_specs
from .workloads import (LayerShape, lm_layers, resnet50_layers,
                        resnet101_layers, tiny_resnet_layers)
