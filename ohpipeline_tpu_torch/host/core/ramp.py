"""Volume-ramp envelope attached to audio events.

Parity target: the reference's `Ramp` (Msg.h:253-286, Msg.cpp:560-800) —
linear multiplier envelopes in [0, kMax=1<<14], with directions
none/up/down/mute, set over a remaining duration, and split together with
the audio they decorate.

Design delta vs the reference (deliberate, TPU-first): the reference applies
ramps on the CPU through a 512-entry lookup table and truncates every
subsample to 16 bits while ramping (Msg.cpp:832-880).  Here the ramp is pure
metadata; the device DSP stage converts (start, end) to a per-sample float32
gain line and multiplies in full precision, preserving 24-bit content.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

RAMP_MAX: int = 1 << 14
RAMP_MIN: int = 0


class RampDirection(enum.Enum):
    NONE = "none"
    UP = "up"
    DOWN = "down"
    MUTE = "mute"


@dataclass(frozen=True, slots=True)
class Ramp:
    """An immutable linear ramp fragment.

    `start`/`end` are multipliers in [RAMP_MIN, RAMP_MAX] applied linearly
    across the audio fragment this ramp decorates.  `enabled=False` means
    unity gain.
    """

    start: int = RAMP_MAX
    end: int = RAMP_MAX
    direction: RampDirection = RampDirection.NONE
    enabled: bool = False

    def __post_init__(self):
        if not (RAMP_MIN <= self.start <= RAMP_MAX
                and RAMP_MIN <= self.end <= RAMP_MAX):
            raise ValueError(f"ramp bounds out of range: {self}")

    # -- constructors -------------------------------------------------------
    @staticmethod
    def unity() -> "Ramp":
        return Ramp()

    @staticmethod
    def muted() -> "Ramp":
        return Ramp(RAMP_MIN, RAMP_MIN, RampDirection.MUTE, True)

    # -- queries ------------------------------------------------------------
    @property
    def is_muted(self) -> bool:
        return self.direction is RampDirection.MUTE

    def value_at(self, frac: float) -> float:
        """Multiplier (0..1) at fraction `frac` in [0,1] through the fragment."""
        if not self.enabled:
            return 1.0
        v = self.start + (self.end - self.start) * frac
        return v / RAMP_MAX

    def median_multiplier(self) -> float:
        """Mid-point multiplier, used when stepping volume instead of samples
        (reference `RampApplicator::MedianMultiplier`, Msg.cpp:901)."""
        if not self.enabled:
            return 1.0
        return ((self.start + self.end) / 2) / RAMP_MAX

    # -- algebra ------------------------------------------------------------
    def split(self, frac: float) -> tuple["Ramp", "Ramp"]:
        """Split into two ramps at fraction `frac` of the fragment."""
        if not self.enabled:
            return self, self
        mid = round(self.start + (self.end - self.start) * frac)
        return (Ramp(self.start, mid, self.direction, True),
                Ramp(mid, self.end, self.direction, True))

    def compose(self, other: "Ramp") -> "Ramp":
        """Apply `other` on top of this ramp (both scale the audio).

        The reference resolves overlapping ramps by selecting the lower
        envelope (`Ramp::SelectLowerRampPoints`, Msg.cpp:640); we do the
        same: pointwise min of the two lines, approximated by min of the
        endpoints (exact when the lines don't cross mid-fragment — matching
        the reference's approximation).
        """
        if not self.enabled:
            return other
        if not other.enabled:
            return self
        direction = other.direction if other.direction is not RampDirection.NONE else self.direction
        return Ramp(min(self.start, other.start), min(self.end, other.end),
                    direction, True)


def set_ramp(start: int, fragment_jiffies: int, remaining_jiffies: int,
             direction: RampDirection) -> tuple[Ramp, int | None]:
    """Compute the ramp covering `fragment_jiffies` of a ramp that has
    `remaining_jiffies` left to run from multiplier `start`.

    Returns ``(ramp, split_jiffies)``.  `split_jiffies` is non-None when the
    ramp completes strictly inside the fragment, and gives the jiffy offset
    at which the caller should split its audio event: the first part carries
    the ramp, the remainder is either unity (up-ramp finished) or muted
    (down-ramp finished).  Mirrors `Ramp::Set` (Msg.cpp:560-636).
    """
    if direction is RampDirection.NONE:
        return Ramp(), None
    if remaining_jiffies <= 0:
        raise ValueError("remaining_jiffies must be positive")
    span = RAMP_MAX - RAMP_MIN
    if direction is RampDirection.UP:
        target = start + (span * fragment_jiffies) // remaining_jiffies
        if target >= RAMP_MAX and fragment_jiffies > remaining_jiffies:
            # ramp completes inside this fragment
            return (Ramp(start, RAMP_MAX, direction, True), remaining_jiffies)
        return Ramp(start, min(target, RAMP_MAX), direction, True), None
    if direction is RampDirection.DOWN:
        target = start - (span * fragment_jiffies) // remaining_jiffies
        if target <= RAMP_MIN and fragment_jiffies > remaining_jiffies:
            return (Ramp(start, RAMP_MIN, direction, True), remaining_jiffies)
        return Ramp(start, max(target, RAMP_MIN), direction, True), None
    # MUTE
    return Ramp.muted(), None
