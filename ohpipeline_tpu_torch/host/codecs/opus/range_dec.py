"""Opus range decoder (RFC 6716 section 4.1), written from the spec.

Reference behaviour target: opus-1.5.2 celt/entdec.c as consumed by the
reference's OpenHome/Media/Codec/Opus.cpp adapter; validated
symbol-for-symbol against the compiled oracle (tools/celt_probe.c
`ecenc`) in tests/test_opus_range.py.

The coder reads range-coded symbols from the front of the buffer and raw
bits from the back (section 4.1.4); `tell`/`tell_frac` expose total bit
usage for the CELT layer's budget decisions.
"""

from __future__ import annotations

SYM_BITS = 8
CODE_BITS = 32
SYM_MAX = (1 << SYM_BITS) - 1
CODE_TOP = 1 << (CODE_BITS - 1)
CODE_BOT = CODE_TOP >> SYM_BITS
CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1
WINDOW_SIZE = 32
UINT_BITS = 8

_MASK31 = CODE_TOP - 1


def ilog(v: int) -> int:
    """Number of bits needed to represent v (EC_ILOG); ilog(0) == 0."""
    return v.bit_length()


class RangeDecoder:
    def __init__(self, data: bytes):
        self.buf = data
        self.storage = len(data)
        self.offs = 0                 # front read position
        self.end_offs = 0             # back read position (raw bits)
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = CODE_BITS + 1 \
            - ((CODE_BITS - CODE_EXTRA) // SYM_BITS) * SYM_BITS
        self.error = 0
        self.rng = 1 << CODE_EXTRA
        self.rem = self._read_byte()
        self.val = self.rng - 1 - (self.rem >> (SYM_BITS - CODE_EXTRA))
        self._normalize()

    # -- byte IO -------------------------------------------------------------
    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    # -- core ----------------------------------------------------------------
    def _normalize(self) -> None:
        while self.rng <= CODE_BOT:
            self.nbits_total += SYM_BITS
            self.rng = (self.rng << SYM_BITS) & 0xFFFFFFFF
            sym = self.rem
            self.rem = self._read_byte()
            sym = ((sym << SYM_BITS) | self.rem) >> (SYM_BITS - CODE_EXTRA)
            self.val = ((self.val << SYM_BITS)
                        + (SYM_MAX & ~sym)) & _MASK31

    def decode(self, ft: int) -> int:
        """Return the cumulative frequency of the next symbol (s4.1.2)."""
        self.ext = self.rng // ft
        s = self.val // self.ext
        return ft - (min(s + 1, ft))

    def decode_bin(self, bits: int) -> int:
        self.ext = self.rng >> bits
        s = self.val // self.ext
        return (1 << bits) - min(s + 1, 1 << bits)

    def update(self, fl: int, fh: int, ft: int) -> None:
        s = self.ext * (ft - fh)
        self.val -= s
        self.rng = self.ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    # -- wrappers (entdec.c API shape) ----------------------------------------
    def dec_bit_logp(self, logp: int) -> int:
        r = self.rng
        d = self.val
        s = r >> logp
        ret = int(d < s)
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def dec_icdf(self, icdf, ftb: int) -> int:
        s = self.rng
        d = self.val
        r = s >> ftb
        ret = -1
        while True:
            ret += 1
            t = s
            s = r * icdf[ret]
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    def dec_uint(self, ft: int) -> int:
        assert ft > 1
        ft -= 1
        ftb = ilog(ft)
        if ftb > UINT_BITS:
            ftb -= UINT_BITS
            ft1 = (ft >> ftb) + 1
            s = self.decode(ft1)
            self.update(s, s + 1, ft1)
            t = (s << ftb) | self.dec_bits(ftb)
            if t <= ft:
                return t
            self.error = 1
            return ft
        s = self.decode(ft + 1)
        self.update(s, s + 1, ft + 1)
        return s

    def dec_bits(self, bits: int) -> int:
        while self.nend_bits < bits:
            self.end_window |= self._read_byte_from_end() << self.nend_bits
            self.nend_bits += SYM_BITS
        ret = self.end_window & ((1 << bits) - 1)
        self.end_window >>= bits
        self.nend_bits -= bits
        self.nbits_total += bits
        return ret

    # -- budget ---------------------------------------------------------------
    def tell(self) -> int:
        return self.nbits_total - ilog(self.rng)

    def tell_frac(self) -> int:
        """Bit usage in 1/8 bits (section 4.1.6.1)."""
        correction = (35733, 38967, 42495, 46340,
                      50535, 55109, 60097, 65535)
        nbits = self.nbits_total << 3
        l = ilog(self.rng)
        r = self.rng >> (l - 16)
        b = (r >> 12) - 8
        b += int(r > correction[b])
        l = (l << 3) + b
        return nbits - l
