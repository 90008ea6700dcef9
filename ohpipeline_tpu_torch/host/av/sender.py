"""Songcast sender integration: the Sender branch with its config
values, and the ProviderSender status state machine.

Parity targets:
- Av/Songcast/Sender.cpp — config values Sender.Enabled / Sender.Channel
  / Sender.Mode / Sender.Preset (Sender.cpp:31-34, registered with
  defaults Yes / random / Unicast / 0 at ctor 56-78, each change pushed
  into the OhmSender: ConfigEnabledChanged..ConfigPresetChanged at
  324-349); mode-based self-disable — audio whose pipeline mode equals
  the device's own Receiver mode is NOT re-sent and enables the unicast
  override (ProcessMsg(MsgMode*), Sender.cpp:121-141);
  NotifyPipelineState -> NotifyAudioPlaying(playing) (107-110).
- ProviderSender in Av/Songcast/OhmSender.cpp:84-293 — the Sender
  service surface: evented PresentationUrl / Metadata / Audio / Status /
  Status2 / Enabled / Attributes, with Status computed from
  enabled+blocked (UpdateStatusEnabledLocked, 254-269) and Status2
  additionally from broadcast-allowed / listeners / playing
  (UpdateStatus2Locked, 271-289), and the 1 s audio-present timeout
  (kTimeoutAudioMs, OhmSender.cpp:27, NotifyAudioPlaying 222-238).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .config import ConfigChoice, ConfigNum

# Sender.cpp:26-34
CHANNEL_MIN, CHANNEL_MAX = 0, 65535
PRESET_MIN, PRESET_MAX, PRESET_NONE = 0, 0x7FFFFFFF, 0
TIMEOUT_AUDIO_S = 1.0  # kTimeoutAudioMs (OhmSender.cpp:27)

STATUS_ENABLED = "Enabled"
STATUS_SENDING = "Sending"
STATUS_READY = "Ready"
STATUS_BLOCKED = "Blocked"
STATUS_INACTIVE = "Inactive"
STATUS_DISABLED = "Disabled"


class SenderStatus:
    """ProviderSender's status machine, minus the wire: tracks
    enabled/blocked/playing/listeners/broadcast-allowed and computes the
    Status and Status2 strings exactly as the reference
    (OhmSender.cpp:254-289).  Observers receive (property, value) for
    every evented change."""

    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = False
        self._blocked = False
        self._playing = False
        self._listeners = False
        self._broadcast_allowed = True
        self.metadata = ""
        self.presentation_url = ""
        self.attributes = ""
        self._observers: list[Callable[[str, object], None]] = []
        self._timer: Optional[threading.Timer] = None
        self.status = STATUS_DISABLED
        self.status2 = STATUS_DISABLED

    def add_observer(self, cb: Callable[[str, object], None]) -> None:
        self._observers.append(cb)

    def _notify(self, prop: str, value) -> None:
        for cb in self._observers:
            cb(prop, value)

    # -- reference update rules -------------------------------------------
    def _update_locked(self) -> list:
        """UpdateStatusEnabledLocked + UpdateStatus2Locked."""
        changes = []
        if not self._enabled:
            status = STATUS_DISABLED
        elif self._blocked:
            status = STATUS_BLOCKED
        else:
            status = STATUS_ENABLED
        if status != self.status:
            self.status = status
            changes.append(("Status", status))
            changes.append(("Enabled", status == STATUS_ENABLED))
        if not self._enabled:
            status2 = STATUS_DISABLED
        elif self._blocked:
            status2 = STATUS_BLOCKED
        elif not self._broadcast_allowed:
            status2 = STATUS_INACTIVE
        elif not self._listeners or not self._playing:
            status2 = STATUS_READY
        else:
            status2 = STATUS_SENDING
        if status2 != self.status2:
            self.status2 = status2
            changes.append(("Status2", status2))
        return changes

    def _apply(self, **fields) -> None:
        with self._lock:
            for k, v in fields.items():
                setattr(self, "_" + k, v)
            changes = self._update_locked()
        for prop, value in changes:
            self._notify(prop, value)

    # -- inputs (ProviderSender's setter surface) --------------------------
    def set_status_enabled(self, enabled: bool) -> None:
        self._apply(enabled=enabled)

    def set_status_blocked(self, blocked: bool) -> None:
        self._apply(blocked=blocked)

    def notify_listeners(self, listeners: bool) -> None:
        self._apply(listeners=listeners)

    def notify_broadcast_allowed(self, allowed: bool) -> None:
        self._apply(broadcast_allowed=allowed)

    def notify_audio_playing(self, playing: bool) -> None:
        """Audio property + Status2; playing arms the 1 s present timer
        that clears Audio when pushes stop (OhmSender.cpp:222-238)."""
        with self._lock:
            changed = playing != self._playing
            self._playing = playing
            changes = self._update_locked() if changed else []
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            if playing:
                self._timer = threading.Timer(
                    TIMEOUT_AUDIO_S, self.notify_audio_playing, (False,))
                self._timer.daemon = True
                self._timer.start()
        if changed:
            self._notify("Audio", playing)
        for prop, value in changes:
            self._notify(prop, value)

    def set_metadata(self, value: str) -> None:
        self.metadata = value
        self._notify("Metadata", value)

    def set_presentation_url(self, value: str) -> None:
        self.presentation_url = value
        self._notify("PresentationUrl", value)

    def close(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None


class SongcastSender:
    """The Av-layer Sender (Av/Songcast/Sender.cpp): owns the OhmSender,
    registers the Sender.* config values and keeps the provider status
    in sync with user config, pipeline mode and pipeline state.

    `ohm` is a net.songcast.OhmSender (or anything with its surface);
    `songcast_mode` is the pipeline mode whose audio must NOT be re-sent
    (the device's own Receiver source, Sender.cpp:121-141)."""

    def __init__(self, config, ohm, name: str = "ohpipeline-tpu",
                 songcast_mode: str = "Receiver",
                 default_channel: Optional[int] = None):
        self.ohm = ohm
        self.name = name
        self.songcast_mode = songcast_mode
        self.provider = SenderStatus()
        self.provider.metadata = self._make_metadata()
        self._user_enabled = True
        self._mode_enabled = True   # Sender::iEnabled
        self._unicast_override_observers: list[Callable[[bool], None]] = []
        self.zone_handler = None  # optional net.songcast.ZoneHandler
        self.preset = PRESET_NONE
        if default_channel is None:
            import random
            default_channel = random.randint(CHANNEL_MIN, CHANNEL_MAX)
        self.cfg_channel = ConfigNum(config, "Sender.Channel",
                                     CHANNEL_MIN, CHANNEL_MAX,
                                     default_channel)
        self.cfg_mode = ConfigChoice(config, "Sender.Mode",
                                     {0: "Multicast", 1: "Unicast"}, 1)
        self.cfg_preset = ConfigNum(config, "Sender.Preset",
                                    PRESET_MIN, PRESET_MAX, PRESET_NONE)
        self.cfg_enabled = ConfigChoice(config, "Sender.Enabled",
                                        {0: "No", 1: "Yes"}, 1)
        self.cfg_channel.subscribe(self._on_channel)
        self.cfg_mode.subscribe(self._on_mode_cfg)
        self.cfg_preset.subscribe(self._on_preset)
        self.cfg_enabled.subscribe(self._on_enabled)
        # config callbacks fire at subscribe (reference ConfigVal
        # semantics), so ohm/provider state already reflects the store

    # -- metadata (OhmSender publishes didl-lite for the sender track) ----
    def _make_metadata(self) -> str:
        return ("<DIDL-Lite><item><dc:title>%s</dc:title>"
                "<upnp:class>object.item.audioItem</upnp:class>"
                "</item></DIDL-Lite>" % self.name)

    def set_name(self, name: str) -> None:
        self.name = name
        self.provider.set_metadata(self._make_metadata())

    # -- config handlers (Sender.cpp:324-349) ------------------------------
    def _on_enabled(self, _key, value) -> None:
        self._user_enabled = bool(value)
        self._apply_enabled()

    def _on_channel(self, _key, value) -> None:
        self.ohm.channel = int(value)

    def _on_mode_cfg(self, _key, value) -> None:
        self.ohm.multicast = (int(value) == 0)

    def _on_preset(self, _key, value) -> None:
        self.preset = int(value)
        if self.zone_handler is not None:
            self.zone_handler.preset = int(value)

    def _apply_enabled(self) -> None:
        enabled = self._user_enabled
        self.provider.set_status_enabled(enabled)

    # -- pipeline inputs ---------------------------------------------------
    def notify_pipeline_state(self, state) -> None:
        value = getattr(state, "value", state)
        self.provider.notify_audio_playing(value == "playing")

    def on_mode(self, mode: str) -> None:
        """Sender::ProcessMsg(MsgMode*): the device's own Receiver audio
        is not re-sent; entering that mode enables the unicast override
        so an upstream sender stops multicasting on our behalf."""
        was = self._mode_enabled
        self._mode_enabled = (mode != self.songcast_mode)
        if self._mode_enabled != was:
            for cb in self._unicast_override_observers:
                cb(not self._mode_enabled)
        self.provider.set_status_blocked(not self._mode_enabled)

    def add_unicast_override_observer(self,
                                      cb: Callable[[bool], None]) -> None:
        self._unicast_override_observers.append(cb)

    def notify_listeners(self, listeners: bool) -> None:
        self.provider.notify_listeners(listeners)

    def close(self) -> None:
        self.provider.close()
