"""LSB-first bit reader (the Vorbis bit-packing convention, spec §2):
bit k of the logical stream is byte[k>>3] >> (k&7).

Counterpart of the MSB-first reader used by FLAC/MP3/AAC; kept separate
because every read direction differs.  Parity: Tremor ogg bitwise.
"""

from __future__ import annotations


class EndOfPacket(Exception):
    pass


class LsbBitReader:
    __slots__ = ("data", "pos", "_val", "_len")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        # one big little-endian integer: bit k is (val >> k) & 1
        self._val = int.from_bytes(data, "little")
        self._len = len(data) * 8

    def read(self, n: int) -> int:
        """Read n bits (0 <= n <= 64).  Reading past the end raises
        EndOfPacket (Vorbis end-of-packet semantics)."""
        if n == 0:
            return 0
        if self.pos + n > self._len:
            raise EndOfPacket
        v = (self._val >> self.pos) & ((1 << n) - 1)
        self.pos += n
        return v

    def peek(self, n: int) -> int:
        """Peek up to n bits, zero-padded past the packet end."""
        return (self._val >> self.pos) & ((1 << n) - 1)

    def read_bit(self) -> int:
        return self.read(1)

    @property
    def bits_left(self) -> int:
        return self._len - self.pos


def ilog(x: int) -> int:
    """Vorbis ilog: position of the highest set bit (ilog(0)=0)."""
    return x.bit_length() if x > 0 else 0


def float32_unpack(x: int) -> float:
    """Vorbis packed float (spec §9.2.2): 21-bit mantissa, sign,
    10-bit biased exponent."""
    mant = x & 0x1FFFFF
    if x & 0x80000000:
        mant = -mant
    exp = (x & 0x7FE00000) >> 21
    return float(mant) * 2.0 ** (exp - 788)


def lookup1_values(entries: int, dims: int) -> int:
    """Largest v with v**dims <= entries (spec §9.2.3)."""
    v = int(entries ** (1.0 / dims))
    while (v + 1) ** dims <= entries:
        v += 1
    while v ** dims > entries:
        v -= 1
    return v
