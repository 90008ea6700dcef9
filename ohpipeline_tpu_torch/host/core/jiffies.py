"""Pipeline timebase.

The unit of pipeline timing is the *jiffy*: 56,448,000 jiffies per second,
the lcm of 384000 and 352800, so one sample at every supported PCM and DSD
rate is an integer number of jiffies.  (Behavioural parity with the
reference's `Jiffies` class, OpenHome/Media/Pipeline/Msg.h:190-238.)
"""

from __future__ import annotations

PER_SECOND: int = 56_448_000
PER_MS: int = PER_SECOND // 1000

#: The 18 supported PCM sample rates (Msg.h:212-229).
PCM_RATES: tuple[int, ...] = (
    7350, 8000, 11025, 12000, 14700, 16000, 22050, 24000, 29400, 32000,
    44100, 48000, 88200, 96000, 176400, 192000, 352800, 384000,
)

#: Supported DSD rates (Msg.h:230-232): 64x/128x/256x of 44.1 kHz.
DSD_RATES: tuple[int, ...] = (2_822_400, 5_644_800, 11_289_600)

_ALL_RATES = frozenset(PCM_RATES) | frozenset(DSD_RATES)

#: Jiffies per sample at the lowest supported rate — the coarsest step.
MAX_JIFFIES_PER_SAMPLE: int = PER_SECOND // 7350


class Jiffies:
    """Static helpers for the 56.448 MHz pipeline timebase."""

    kPerSecond = PER_SECOND
    kPerMs = PER_MS

    @staticmethod
    def is_valid_sample_rate(rate: int) -> bool:
        return rate in _ALL_RATES

    @staticmethod
    def per_sample(rate: int) -> int:
        if rate not in _ALL_RATES:
            raise ValueError(f"unsupported sample rate {rate}")
        return PER_SECOND // rate

    @staticmethod
    def to_ms(jiffies: int) -> int:
        return jiffies // PER_MS

    @staticmethod
    def from_ms(ms: int) -> int:
        return ms * PER_MS

    @staticmethod
    def to_samples(jiffies: int, rate: int) -> int:
        return jiffies // Jiffies.per_sample(rate)

    @staticmethod
    def from_samples(samples: int, rate: int) -> int:
        return samples * Jiffies.per_sample(rate)

    @staticmethod
    def round_down(jiffies: int, rate: int) -> int:
        """Largest whole-sample jiffy count <= `jiffies` at `rate`."""
        per = Jiffies.per_sample(rate)
        return (jiffies // per) * per

    @staticmethod
    def round_up(jiffies: int, rate: int) -> int:
        """Smallest whole-sample jiffy count >= `jiffies` at `rate`."""
        per = Jiffies.per_sample(rate)
        return ((jiffies + per - 1) // per) * per

    @staticmethod
    def to_bytes(jiffies: int, rate: int, num_channels: int,
                 bits_per_subsample: int) -> tuple[int, int]:
        """Convert a jiffy span to a whole-sample byte count.

        Returns ``(bytes, rounded_jiffies)`` where ``rounded_jiffies`` is the
        input rounded down to a whole number of samples (mirrors the
        in/out-param contract of the reference's ``Jiffies::ToBytes``,
        Msg.h:198).
        """
        per = Jiffies.per_sample(rate)
        samples = jiffies // per
        return samples * num_channels * (bits_per_subsample // 8), samples * per

    # Songcast wire time: 256 ticks per sample in the 44.1k or 48k family.
    @staticmethod
    def songcast_ticks_per_second(rate: int) -> int:
        if rate % 147 == 0:  # 44.1kHz family (44100 = 147 * 300)
            return 44100 * 256
        return 48000 * 256

    @staticmethod
    def to_songcast_time(jiffies: int, rate: int) -> int:
        ticks = Jiffies.songcast_ticks_per_second(rate)
        return (jiffies * ticks) // PER_SECOND

    @staticmethod
    def from_songcast_time(songcast_time: int, rate: int) -> int:
        ticks = Jiffies.songcast_ticks_per_second(rate)
        return (songcast_time * PER_SECOND) // ticks
