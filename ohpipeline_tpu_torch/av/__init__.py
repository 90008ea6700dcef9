"""The Av layer of the port: the media player, its product and sources, the
volume chain, config and power management.

Port of ``ohpipeline_tpu.av``; exports every name of its ``__all__``.
:class:`MediaPlayer` (``media_player.py``) builds its pipeline on a device,
the port's ``pipeline.PipelineManager``; the rest is host code, the port's
copies under ``host/av/``.  A volume change reaches the device as the
attenuation of each audio event, which the animator's ``RenderBatcher``
applies in its gain pass on its device.

    mp = MediaPlayer(device="cuda")
    mp.start()
    try:
        ids = [mp.source_playlist.db.insert(0, uri) for uri in uris]
        mp.source_playlist.seek_id(ids[0])
        AnimatorBatch(mp.pipeline.pipeline.predriver, sink,
                      device=mp.device).run()
    finally:
        mp.quit()
"""

from ..host.av import (ConfigChoice, ConfigManager, ConfigNum, ConfigText,
                       ConfigTextChoice, FileStore, PowerManager,
                       PresetDatabase, Product, RamStore, Source,
                       SourcePlaylist, SourceRadio, StoreVal, TrackDatabase,
                       UriProviderPlaylist, UriProviderRadio, VolumeManager,
                       VolumeProfile)
from .media_player import MediaPlayer, MediaPlayerInitParams

__all__ = [
    "ConfigChoice", "ConfigManager", "ConfigNum", "ConfigText",
    "ConfigTextChoice", "FileStore", "RamStore", "MediaPlayer",
    "MediaPlayerInitParams", "PowerManager", "StoreVal", "Product",
    "Source", "PresetDatabase", "SourcePlaylist", "SourceRadio",
    "TrackDatabase", "UriProviderPlaylist", "UriProviderRadio",
    "VolumeManager", "VolumeProfile",
]
