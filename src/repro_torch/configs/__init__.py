"""Named epitome variants, ``get_resnet``, the LM registry and the
input-shape cells."""
from .archs import LONG_CONTEXT_OK
from .registry import (ARCHS, RESNET_ARCHS, SHAPES, EpitomeSettings, ShapeCell,
                       epitome_settings, get_config, get_resnet, get_smoke_config,
                       input_specs, shape_applicable)
