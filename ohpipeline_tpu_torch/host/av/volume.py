"""Volume management: the composable volume element chain.

Parity target: OpenHome/Av/VolumeManager.h:63-741 — a stack of small
IVolume decorators mirroring the reference constructor order
(VolumeManager.cpp:1059-1112): user -> limiter -> reporter -> source
offset -> source unity gain -> config unity gain -> surround boost ->
ramper -> stepped muter -> driver muter -> sink; a mute chain
(MuteUser -> MuteReporter -> stepped muter), balance/fade, per-channel
volume offsets (Av/VolumeOffsets.h) and trims (Av/Trim.h), VolumeConfig
persistence, IVolumeProfile limits.  Error semantics follow the
reference: raising volume while pinned at the limit throws
VolumeOutOfRange (the provider maps to UPnP/ODP error 811 only above
VolumeMax, ProviderVolume.cpp:573-585) and volume changes during unity
gain throw VolumeNotSupported (814).

Volume unit convention follows the reference: integer volume in
`binary-milli-db` steps via VolumeConfig (user range 0..max in steps of
`volume_step`); the final stage maps to a linear multiplier for the
device gain chain (ops.pcm.apply_gain) or to a hardware IVolume driver.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .config import ConfigManager


class VolumeOutOfRange(ValueError):
    pass


class VolumeNotSupported(Exception):
    """Volume control is currently disabled (unity-gain source / fixed
    volume); reference THROW(VolumeNotSupported), VolumeManager.cpp:414."""


class BalanceOutOfRange(ValueError):
    """Balance beyond +/-BalanceMax (reference BalanceUser::SetBalance,
    VolumeManager.cpp:737-745; provider error 812)."""


class FadeOutOfRange(ValueError):
    """Fade beyond +/-FadeMax (VolumeManager.cpp:770-778; error 813)."""


class ChannelInvalid(KeyError):
    """Unknown volume-offset channel (Av/VolumeOffsets.h EXCEPTION
    ChannelInvalid; provider error 816)."""


class VolumeOffsetOutOfRange(ValueError):
    """Per-channel offset beyond the device range (Av/VolumeOffsets.h;
    provider error 817)."""


class TrimChannelInvalid(KeyError):
    """Unknown trim channel (Av/Trim.h EXCEPTION TrimChannelInvalid;
    provider error 816)."""


class TrimOutOfRange(ValueError):
    """Trim beyond the channel's min/max (Av/Trim.h; provider error
    819)."""


class IVolume:
    def set_volume(self, volume: int) -> None:
        raise NotImplementedError


class VolumeProfile:
    """IVolumeProfile (VolumeManager.h:63): device capabilities."""

    def __init__(self, max_volume=100, default_volume=45, step=1,
                 default_limit=85, milli_db_per_step=1024, fade_max=10,
                 balance_max=12, offset_max=15, always_on=False,
                 unity_volume: Optional[int] = None):
        self.max_volume = max_volume
        self.default_volume = default_volume
        self.step = step
        self.default_limit = default_limit
        self.milli_db_per_step = milli_db_per_step
        self.fade_max = fade_max
        self.balance_max = balance_max
        self.offset_max = offset_max
        self.always_on = always_on
        # VolumeUnity (VolumeConfig::VolumeUnity) — the volume the unity
        # gain stages pin while volume control is disabled; devices that
        # don't distinguish it use full scale
        self.unity_volume = unity_volume if unity_volume is not None \
            else max_volume


class VolumeElement(IVolume):
    """Base decorator: passes volume downstream."""

    def __init__(self, downstream: IVolume):
        self._down = downstream

    def set_volume(self, volume: int) -> None:
        self._down.set_volume(volume)


class VolumeUser(VolumeElement):
    """Entry element: user range checks, startup/last-used volume, standby
    reapply (reference VolumeUser, VolumeManager.cpp:90-215).

    Reference semantics mirrored exactly:
    * SetVolume above max clamps TO max if the current volume is still
      below max, and only throws VolumeOutOfRange when already pinned at
      max (VolumeManager.cpp:150-160);
    * every accepted volume persists as the last-used volume
      (iStoreUserVolume, write-through here instead of the 2 s deferred
      timer);
    * startup-volume disabled means "start at last-used volume"
      (ApplyStartupVolume, VolumeManager.cpp:191-206);
    * leaving standby reapplies the startup volume, swallowing
      OutOfRange/NotSupported (StandbyDisabled, VolumeManager.cpp:177-180).
    """

    STORE_KEY = "Volume.LastUsed"

    def __init__(self, downstream, profile: VolumeProfile,
                 config: ConfigManager, power=None):
        super().__init__(downstream)
        self.profile = profile
        self._store = config.store
        self._startup = config.create_num(
            "Volume.StartupValue", 0, profile.max_volume,
            profile.default_volume)
        self._startup_enabled = config.create_choice(
            "Volume.StartupEnabled", {0: "Off", 1: "On"}, 1)
        self.volume = self._last_used()
        if power is not None:
            power.register_standby_handler(50, self)
        self._apply_startup_volume()

    def _last_used(self) -> int:
        try:
            return max(0, min(self.profile.max_volume, int(
                self._store.read(self.STORE_KEY).decode())))
        except Exception:                          # noqa: BLE001 — absent key
            return self.profile.default_volume

    def _apply_startup_volume(self) -> None:
        startup = (self._startup.value if self._startup_enabled.value
                   else self._last_used())
        try:
            self.set_volume(startup)
        except (VolumeNotSupported, VolumeOutOfRange):
            pass      # e.g. limit configured lower than startup volume

    # -- IStandbyHandler (PowerManager) --------------------------------
    def standby_enabled(self) -> None:
        pass          # volume unchanged on entering standby

    def standby_disabled(self) -> None:
        self._apply_startup_volume()

    def set_volume(self, volume: int) -> None:
        if volume < 0:
            raise VolumeOutOfRange(volume)
        if volume > self.profile.max_volume:
            if self.volume < self.profile.max_volume:
                volume = self.profile.max_volume
            else:
                raise VolumeOutOfRange(volume)
        self._down.set_volume(volume)
        self.volume = volume
        self._store.write(self.STORE_KEY, str(volume).encode())


class VolumeLimiter(VolumeElement):
    """Caps volume at a configurable limit (reference VolumeLimiter,
    VolumeManager.cpp:212-255): raising the volume further while already
    pinned at the limit throws VolumeOutOfRange (the control point sees
    error 811 instead of a silent no-op), and the stored current volume
    is the *clamped* one (so raising the limit later does not restore a
    higher pre-clamp request — reference DoSetVolume)."""

    def __init__(self, downstream, profile: VolumeProfile,
                 config: ConfigManager):
        super().__init__(downstream)
        self._current = 0
        self._limit = config.create_num("Volume.Limit", 0,
                                        profile.max_volume,
                                        profile.default_limit)
        self._limit.subscribe(self._on_limit)

    def _on_limit(self, key, value):
        try:
            self._do_set_volume()
        except (VolumeNotSupported, VolumeOutOfRange):
            pass                    # reference LimitChanged swallows both

    def _do_set_volume(self) -> None:
        self._current = min(self._current, self._limit.value)
        self._down.set_volume(self._current)

    def set_volume(self, volume: int) -> None:
        limit = self._limit.value
        if volume > limit and self._current >= limit:
            raise VolumeOutOfRange(volume)
        self._current = volume
        self._do_set_volume()


class VolumeReporter(VolumeElement):
    """Fans the post-limit volume out to observers (UPnP/ODP eventing)."""

    def __init__(self, downstream):
        super().__init__(downstream)
        self._observers: list[Callable[[int], None]] = []
        self.volume = 0

    def add_observer(self, cb: Callable[[int], None]) -> None:
        self._observers.append(cb)
        cb(self.volume)

    def set_volume(self, volume: int) -> None:
        self.volume = volume
        for cb in self._observers:
            cb(volume)
        self._down.set_volume(volume)


class VolumeSourceOffset(VolumeElement):
    """Per-source volume offset (reference VolumeSourceOffset).

    Mirrors VolumeManager.cpp DoSetVolume: user volume 0 always forces
    downstream 0 (a positive source offset must never make a muted-by-zero
    device audible).
    """

    def __init__(self, downstream):
        super().__init__(downstream)
        self._offset = 0
        self._current = 0

    def _apply(self, volume: int) -> None:
        if volume == 0:
            self._down.set_volume(0)
        else:
            self._down.set_volume(max(0, volume + self._offset))

    def set_offset(self, offset: int) -> None:
        self._offset = offset
        try:
            self._apply(self._current)
        except VolumeNotSupported:
            pass      # reference SetVolumeOffset swallows (cpp:327-334)

    def set_volume(self, volume: int) -> None:
        # reference SetVolume records iUpstreamVolume only after
        # DoSetVolume succeeds (cpp:318-324) — a VolumeNotSupported from
        # the unity-gain stage must not update the remembered volume
        self._apply(volume)
        self._current = volume


class VolumeUnityGainBase(VolumeElement):
    """Pins the downstream at the unity volume while volume control is
    DISABLED (reference VolumeUnityGainBase, VolumeManager.cpp:395-437):
    SetVolume then throws VolumeNotSupported so control points see error
    814 rather than a silently-ignored change; the upstream volume is
    recorded only after a successful downstream push."""

    def __init__(self, downstream, unity_volume: int):
        super().__init__(downstream)
        self._unity = unity_volume
        self._control_enabled = True
        self._current = 0

    @property
    def volume_control_enabled(self) -> bool:
        return self._control_enabled

    @property
    def unity_gain(self) -> bool:
        return not self._control_enabled

    def set_volume_control_enabled(self, enabled: bool) -> None:
        self._control_enabled = enabled
        # reference SetVolumeControlEnabled pushes the new effective
        # volume, swallowing VolumeNotSupported from the stage below
        try:
            self._down.set_volume(self._current if enabled
                                  else self._unity)
        except VolumeNotSupported:
            pass

    def set_volume(self, volume: int) -> None:
        if not self._control_enabled:
            raise VolumeNotSupported(volume)
        self._down.set_volume(volume)
        self._current = volume


class VolumeUnityGain(VolumeUnityGainBase):
    """Config-driven unity gain: 'Volume.Enabled' = No fixes the device
    at unity (reference VolumeUnityGain, VolumeManager.cpp:440-457 —
    which subscribes then immediately unsubscribes, i.e. the value is
    read once at construction and changing it takes a restart)."""

    def __init__(self, downstream, config: ConfigManager,
                 unity_volume: int):
        super().__init__(downstream, unity_volume)
        enabled = config.create_choice("Volume.Enabled",
                                       {0: "No", 1: "Yes"}, 1)
        self.set_volume_control_enabled(enabled.value == 1)


class VolumeSourceUnityGain(VolumeUnityGainBase):
    """Source-driven unity gain (analog bypass / fixed-volume sources;
    reference VolumeSourceUnityGain, VolumeManager.cpp:460-483) with
    unity-gain observers that get an immediate callback on add."""

    def __init__(self, downstream, unity_volume: int):
        super().__init__(downstream, unity_volume)
        self._observers: list[Callable[[bool], None]] = []
        self.set_volume_control_enabled(True)

    def set_unity_gain(self, enable: bool) -> None:
        self.set_volume_control_enabled(not enable)
        for cb in self._observers:
            cb(self.unity_gain)

    def add_unity_gain_observer(self, cb: Callable[[bool], None]) -> None:
        cb(self.unity_gain)
        self._observers.append(cb)


class VolumeSurroundBoost(VolumeElement):
    """Signed boost applied below unity gain (reference
    VolumeSurroundBoost, VolumeManager.cpp:352-396): zero upstream volume
    stays silent, a negative boost larger than the volume floors at 0."""

    def __init__(self, downstream):
        super().__init__(downstream)
        self._boost = 0
        self._current = 0

    def set_volume_boost(self, boost: int) -> None:
        self._boost = boost
        try:
            self._apply()
        except (VolumeNotSupported, VolumeOutOfRange):
            pass                    # reference SetVolumeBoost swallows

    def set_volume(self, volume: int) -> None:
        self._current = volume
        self._apply()

    def _apply(self) -> None:
        volume = self._current
        if volume != 0:
            volume = max(0, volume + self._boost)
        self._down.set_volume(volume)


class VolumeRamperVol(VolumeElement):
    """Steps volume gradually on large jumps (reference VolumeRamper in the
    *volume* domain; the pipeline's VolumeRamperElement handles the
    analog-bypass sample domain)."""

    def __init__(self, downstream, ms_per_step: int = 5,
                 timer: Optional[Callable] = None):
        super().__init__(downstream)
        self._target = 0
        self._current = 0
        self._lock = threading.Lock()

    def set_volume(self, volume: int) -> None:
        # instantaneous in this build; the device gain chain already ramps
        # samples, so volume stepping only matters for HW volume drivers
        self._current = volume
        self._down.set_volume(volume)


class VolumeMuterStep(VolumeElement):
    """Mute by stepping volume to zero (reference VolumeMuterStepped)."""

    def __init__(self, downstream):
        super().__init__(downstream)
        self.muted = False
        self._current = 0

    def mute(self) -> None:
        self.muted = True
        self._down.set_volume(0)

    def unmute(self) -> None:
        self.muted = False
        self._down.set_volume(self._current)

    def set_volume(self, volume: int) -> None:
        self._current = volume
        if not self.muted:
            self._down.set_volume(volume)


class VolumeMuter(VolumeElement):
    """Terminal driver-level mute (reference VolumeMuter,
    VolumeManager.cpp:686-720, IVolumeMuter): zeroes the downstream
    volume while muted, remembers upstream pushes so unmute restores
    them.  Sits below the stepped muter — the animator/driver uses it
    for hard mute without ramping."""

    def __init__(self, downstream):
        super().__init__(downstream)
        self._muted = False
        self._current = 0

    def set_volume(self, volume: int) -> None:
        self._current = volume
        self._do_set_volume()

    def set_volume_muted(self, muted: bool) -> None:
        self._muted = muted
        self._do_set_volume()

    def _do_set_volume(self) -> None:
        self._down.set_volume(0 if self._muted else self._current)


class MuteReporter:
    """Fans mute-state changes out to observers, deduplicating repeats
    (reference MuteReporter, VolumeManager.cpp:828-868)."""

    def __init__(self, downstream):
        self._down = downstream
        self._observers: list[Callable[[bool], None]] = []
        self.muted = False

    def add_observer(self, cb: Callable[[bool], None]) -> None:
        cb(self.muted)
        self._observers.append(cb)

    def _report(self, muted: bool) -> bool:
        if muted == self.muted:
            return False
        self.muted = muted
        for cb in self._observers:
            cb(muted)
        return True

    def mute(self) -> None:
        if self._report(True):
            self._down.mute()

    def unmute(self) -> None:
        if self._report(False):
            self._down.unmute()


class MuteUser:
    """User-facing mute entry: clears mute when leaving standby
    (reference MuteUser, VolumeManager.cpp:789-825)."""

    def __init__(self, downstream, power=None):
        self._down = downstream
        if power is not None:
            power.register_standby_handler(50, self)

    def mute(self) -> None:
        self._down.mute()

    def unmute(self) -> None:
        self._down.unmute()

    # -- IStandbyHandler ------------------------------------------------
    def standby_enabled(self) -> None:
        pass          # mute unchanged entering standby

    def standby_disabled(self) -> None:
        self._down.unmute()


class VolumeOffsets:
    """Per-channel volume offsets in binary-milli-db (reference
    IVolumeOffsetter, Av/VolumeOffsets.h:62-87): the collection a
    multichannel integration feeds its per-channel volume drivers;
    observers receive the visitable immediately on add and after every
    change (ProviderVolume serialises it to the evented VolumeOffsets
    JSON array, ProviderVolume.cpp:543-554)."""

    def __init__(self, config: ConfigManager,
                 channels: tuple = ("Left", "Right"),
                 offset_max_bmdb: int = 15 * 1024):
        self.offset_max = offset_max_bmdb
        self._vals = {
            ch: config.create_num(f"Volume.Offset.{ch}",
                                  -offset_max_bmdb, offset_max_bmdb, 0)
            for ch in channels}
        self._observers: list[Callable[["VolumeOffsets"], None]] = []

    def set_volume_offset(self, channel: str, offset_bmdb: int) -> None:
        val = self._vals.get(channel)
        if val is None:
            raise ChannelInvalid(channel)
        try:
            val.set(int(offset_bmdb))
        except ValueError:
            raise VolumeOffsetOutOfRange(offset_bmdb) from None
        for cb in self._observers:
            cb(self)

    def get_volume_offset(self, channel: str) -> int:
        val = self._vals.get(channel)
        if val is None:
            raise ChannelInvalid(channel)
        return val.value

    def visit(self, fn: Callable[[str, int], None]) -> None:
        """IVolumeOffsetterVisitor analogue: fn(channel, offset)."""
        for ch, val in self._vals.items():
            fn(ch, val.value)

    def add_observer(self, cb: Callable[["VolumeOffsets"], None]) -> None:
        cb(self)              # immediate callback, reference contract
        self._observers.append(cb)


class Trims:
    """Per-channel trims in binary-milli-db (reference ITrim,
    Av/Trim.h:48-71): SetTrim validates the channel and the channel's
    min/max; observers receive the visitable immediately on add and
    after every change (ProviderVolume serialises to the evented Trim
    JSON array, ProviderVolume.cpp:556-568)."""

    def __init__(self, config: ConfigManager,
                 channels: tuple = ("Left", "Right"),
                 min_bmdb: int = -10 * 1024, max_bmdb: int = 10 * 1024):
        self.min_bmdb = min_bmdb
        self.max_bmdb = max_bmdb
        self._vals = {
            ch: config.create_num(f"Volume.Trim.{ch}",
                                  min_bmdb, max_bmdb, 0)
            for ch in channels}
        self._observers: list[Callable[["Trims"], None]] = []

    @property
    def trim_channel_count(self) -> int:
        return len(self._vals)

    def set_trim(self, channel: str, trim_bmdb: int) -> None:
        val = self._vals.get(channel)
        if val is None:
            raise TrimChannelInvalid(channel)
        try:
            val.set(int(trim_bmdb))
        except ValueError:
            raise TrimOutOfRange(trim_bmdb) from None
        for cb in self._observers:
            cb(self)

    def get_trim(self, channel: str) -> int:
        val = self._vals.get(channel)
        if val is None:
            raise TrimChannelInvalid(channel)
        return val.value

    def visit(self, fn: Callable[[str, int, int, int], None]) -> None:
        """ITrimVisitor analogue: fn(channel, min, max, trim)."""
        for ch, val in self._vals.items():
            fn(ch, self.min_bmdb, self.max_bmdb, val.value)

    def add_observer(self, cb: Callable[["Trims"], None]) -> None:
        cb(self)              # immediate callback, reference contract
        self._observers.append(cb)

    def channel_multipliers(self) -> dict[str, float]:
        """Linear per-channel gains for a software render integration
        (the reference leaves application to the integration's hardware
        volume drivers)."""
        return {ch: 10.0 ** ((val.value / 1024.0) / 20.0)
                for ch, val in self._vals.items()}


class VolumeSink(IVolume):
    """Terminal element: converts steps to a linear multiplier for the
    device render gain (or a HW driver callback)."""

    def __init__(self, profile: VolumeProfile,
                 hw: Optional[Callable[[int], None]] = None):
        self.profile = profile
        self.volume = 0
        self._hw = hw
        self._listeners: list[Callable[[float], None]] = []

    def add_gain_listener(self, cb: Callable[[float], None]) -> None:
        self._listeners.append(cb)

    @property
    def multiplier(self) -> float:
        if self.volume <= 0:
            return 0.0
        # milli-db per step -> linear; reference maps steps to binary-milli-db
        db = (self.volume - self.profile.max_volume) \
            * self.profile.milli_db_per_step / 1024.0
        return 10.0 ** (db / 20.0)

    def set_volume(self, volume: int) -> None:
        self.volume = volume
        if self._hw:
            self._hw(volume)
        m = self.multiplier
        for cb in self._listeners:
            cb(m)


class BalanceFade:
    """Balance (left/right) and fade (front/rear) trims
    (reference VolumeBalance/VolumeFade + Trim.h)."""

    def __init__(self, profile: VolumeProfile, config: ConfigManager):
        self.profile = profile
        self._balance = config.create_num("Volume.Balance",
                                          -profile.balance_max,
                                          profile.balance_max, 0)
        self._fade = config.create_num("Volume.Fade", -profile.fade_max,
                                       profile.fade_max, 0)

    @property
    def balance(self) -> int:
        return self._balance.value

    @property
    def fade(self) -> int:
        return self._fade.value

    def set_balance(self, v: int) -> None:
        # reference BalanceUser::SetBalance translates the config range
        # error (VolumeManager.cpp:737-745)
        try:
            self._balance.set(v)
        except ValueError:
            raise BalanceOutOfRange(v) from None

    def set_fade(self, v: int) -> None:
        try:
            self._fade.set(v)
        except ValueError:
            raise FadeOutOfRange(v) from None

    def subscribe_balance(self, cb) -> None:
        self._balance.subscribe(cb)

    def subscribe_fade(self, cb) -> None:
        self._fade.subscribe(cb)

    def channel_gains(self, num_channels: int = 2) -> list[float]:
        """Per-channel multipliers implementing balance (device render
        applies these via the gain chain)."""
        b = self.balance
        db_per = 1.5
        left = min(0.0, -b * db_per)
        right = min(0.0, b * db_per)
        gains = [10 ** (left / 20), 10 ** (right / 20)]
        while len(gains) < num_channels:
            gains.append(1.0)
        return gains[:num_channels]


class VolumeManager(IVolume):
    """Assembles the chain and fronts it (VolumeManager.h:638)."""

    def __init__(self, config: ConfigManager,
                 profile: Optional[VolumeProfile] = None,
                 hw: Optional[Callable[[int], None]] = None,
                 power=None, offsetter: Optional[VolumeOffsets] = None,
                 trims: Optional[Trims] = None):
        self.profile = profile or VolumeProfile()
        unity = self.profile.unity_volume
        self.sink = VolumeSink(self.profile, hw)
        self.volume_muter = VolumeMuter(self.sink)
        self.muter = VolumeMuterStep(self.volume_muter)
        self.ramper = VolumeRamperVol(self.muter)
        self.boost = VolumeSurroundBoost(self.ramper)
        # reference VolumeManager ctor (VolumeManager.cpp:1096-1104):
        # AlwaysOn devices skip the config-driven unity stage; the
        # source-driven stage always exists
        if self.profile.always_on:
            self.unity_cfg = None
            self.unity = VolumeSourceUnityGain(self.boost, unity)
        else:
            self.unity_cfg = VolumeUnityGain(self.boost, config, unity)
            self.unity = VolumeSourceUnityGain(self.unity_cfg, unity)
        self.offset = VolumeSourceOffset(self.unity)
        self.reporter = VolumeReporter(self.offset)
        self.limiter = VolumeLimiter(self.reporter, self.profile, config)
        self.user = VolumeUser(self.limiter, self.profile, config, power)
        self.balance_fade = BalanceFade(self.profile, config)
        self.mute_reporter = MuteReporter(self.muter)
        self.mute_user = MuteUser(self.mute_reporter, power)
        # VolumeConsumer extras (reference wires them from the
        # integration; None => provider reports 815/818 NotSupported)
        self.offsetter = offsetter
        self.trims = trims

    # -- public API (ProviderVolume calls these) ---------------------------
    @property
    def volume(self) -> int:
        return self.user.volume

    def set_volume(self, volume: int) -> None:
        # "OpenHome Volume service is expected to unmute" — the reference
        # unmutes BEFORE pushing the volume (VolumeManager.cpp:1255-1271)
        self.mute_user.unmute()
        self.user.set_volume(volume)

    def set_volume_no_unmute(self, volume: int) -> None:
        """SetVolume minus the unmute (VolumeManager.cpp:1273-1282)."""
        self.user.set_volume(volume)

    def volume_inc(self) -> None:
        # provider semantics: out-of-range on inc/dec is ignored
        # (ProviderVolume HelperSetVolume ErrorOutOfRange::Ignore)
        try:
            self.set_volume(self.volume + self.profile.step)
        except VolumeOutOfRange:
            pass

    def volume_dec(self) -> None:
        if self.volume == 0:
            return                    # ProviderVolume::VolumeDec no-op
        try:
            self.set_volume(self.volume - self.profile.step)
        except VolumeOutOfRange:
            pass

    def volume_inc_no_unmute(self) -> None:
        try:
            self.set_volume_no_unmute(self.volume + self.profile.step)
        except VolumeOutOfRange:
            pass

    def volume_dec_no_unmute(self) -> None:
        if self.volume == 0:
            return
        try:
            self.set_volume_no_unmute(self.volume - self.profile.step)
        except VolumeOutOfRange:
            pass

    def mute(self) -> None:
        self.mute_user.mute()

    def unmute(self) -> None:
        self.mute_user.unmute()

    @property
    def muted(self) -> bool:
        return self.mute_reporter.muted

    def set_volume_boost(self, boost: int) -> None:
        self.boost.set_volume_boost(boost)

    # -- unity gain (source-driven; VolumeManager.cpp:1188-1193) -----------
    @property
    def unity_gain(self) -> bool:
        return self.unity.unity_gain

    def set_unity_gain(self, enable: bool) -> None:
        self.unity.set_unity_gain(enable)

    def add_unity_gain_observer(self, cb: Callable[[bool], None]) -> None:
        self.unity.add_unity_gain_observer(cb)

    # -- driver mute (IVolumeMuter, VolumeManager.cpp:1310-1318) -----------
    def set_volume_muted(self, muted: bool) -> None:
        self.volume_muter.set_volume_muted(muted)

    def add_observer(self, cb: Callable[[int], None]) -> None:
        self.reporter.add_observer(cb)

    def add_mute_observer(self, cb: Callable[[bool], None]) -> None:
        self.mute_reporter.add_observer(cb)
