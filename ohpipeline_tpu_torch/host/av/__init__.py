"""The Av device/application layer (reference OpenHome/Av/, SURVEY.md
§2.4-2.5): media-player composition root, product/source model, volume
chain, typed persistent config, power management, sources.

The port's copy of the JAX package's ``av/__init__.py`` without
``media_player``: the composition root builds a pipeline on a device, so it
is the port's ``ohpipeline_tpu_torch/av/media_player.py``, and
``ohpipeline_tpu_torch.av`` exports every name of this list and it.  The
modules here are whole copies of the JAX package's ``av/`` files."""

from .config import (ConfigChoice, ConfigManager, ConfigNum, ConfigText,
                     ConfigTextChoice, FileStore, RamStore)
from .power import PowerManager, StoreVal
from .product import Product, Source
from .sources import (PresetDatabase, SourcePlaylist, SourceRadio,
                      TrackDatabase, UriProviderPlaylist, UriProviderRadio)
from .volume import VolumeManager, VolumeProfile

__all__ = [
    "ConfigChoice", "ConfigManager", "ConfigNum", "ConfigText",
    "ConfigTextChoice", "FileStore", "RamStore", "PowerManager", "StoreVal",
    "Product", "Source", "PresetDatabase", "SourcePlaylist", "SourceRadio",
    "TrackDatabase", "UriProviderPlaylist", "UriProviderRadio",
    "VolumeManager", "VolumeProfile",
]
