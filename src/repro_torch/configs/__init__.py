"""Named epitome variants and ``get_resnet``."""
from .registry import RESNET_ARCHS, EpitomeSettings, epitome_settings, get_resnet
