"""Named epitome variants, ``get_resnet`` and the LM registry."""
from .registry import (ARCHS, RESNET_ARCHS, EpitomeSettings, epitome_settings,
                       get_config, get_resnet, get_smoke_config)
