"""Vorbis codebooks: header parse, canonical codeword assignment, fast
Huffman decode (LSB-first arrival), VQ value lookup.

Spec §3 (codebook format + assignment) / §9.2; behavioural parity:
Tremor codebook.c/sharedbook.c.
"""

from __future__ import annotations

import numpy as np

from .bitreader import LsbBitReader, float32_unpack, ilog, lookup1_values


class VorbisError(Exception):
    pass


def assign_codewords(lengths: list[int]) -> dict[int, int]:
    """Canonical Vorbis codeword assignment (spec §3.2.1): entries get
    the lowest available codeword of their length, allocating a prefix
    tree left-to-right.  Codewords returned MSB-first (root = MSB).
    Left-justified 32-bit bookkeeping."""
    codes: dict[int, int] = {}
    available = [0] * 33
    first = True
    for i, l in enumerate(lengths):
        if l <= 0:
            continue
        if first:
            codes[i] = 0
            for j in range(1, l + 1):
                available[j] = 1 << (32 - j)
            first = False
            continue
        # find the longest prefix with a free right branch
        j = l
        while j > 0 and available[j] == 0:
            j -= 1
        if j == 0:
            raise VorbisError("over-specified codebook")
        c = available[j]
        available[j] = 0
        for k in range(j + 1, l + 1):
            available[k] = c + (1 << (32 - k))
        codes[i] = c >> (32 - l)
    return codes


def _reverse_bits(x: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


class Codebook:
    """One parsed codebook with decode support."""

    LUT_BITS = 11

    def __init__(self, br: LsbBitReader):
        if br.read(24) != 0x564342:      # "BCV"
            raise VorbisError("bad codebook sync")
        self.dims = br.read(16)
        self.entries = br.read(24)
        lengths = [0] * self.entries
        if br.read_bit():                # ordered
            cur_len = br.read(5) + 1
            i = 0
            while i < self.entries:
                num = br.read(ilog(self.entries - i))
                for _ in range(num):
                    if i >= self.entries:
                        raise VorbisError("ordered overflow")
                    lengths[i] = cur_len
                    i += 1
                cur_len += 1
        else:
            sparse = br.read_bit()
            for i in range(self.entries):
                if sparse and not br.read_bit():
                    lengths[i] = 0
                else:
                    lengths[i] = br.read(5) + 1
        self.lengths = lengths
        self._used = [i for i, l in enumerate(lengths) if l > 0]
        if len(self._used) == 1:
            # single-entry book: spec decodes it by reading its length in
            # bits and always returning the entry
            self._single = (self._used[0], lengths[self._used[0]])
            self._codes = {self._used[0]: 0}
        else:
            self._single = None
            self._codes = assign_codewords(lengths)
        self._build_lut()

        # VQ lookup
        self.lookup_type = br.read(4)
        self.vectors: np.ndarray | None = None
        if self.lookup_type == 0:
            return
        if self.lookup_type not in (1, 2):
            raise VorbisError("bad lookup type")
        minimum = float32_unpack(br.read(32))
        delta = float32_unpack(br.read(32))
        value_bits = br.read(4) + 1
        sequence_p = br.read_bit()
        if self.lookup_type == 1:
            n_mult = lookup1_values(self.entries, self.dims)
        else:
            n_mult = self.entries * self.dims
        mult = np.array([br.read(value_bits) for _ in range(n_mult)],
                        np.float64)
        vec = np.zeros((self.entries, self.dims))
        if self.lookup_type == 1:
            idx = np.arange(self.entries)
            last = np.zeros(self.entries)
            div = 1
            for d in range(self.dims):
                off = (idx // div) % n_mult
                vec[:, d] = mult[off] * delta + minimum + last
                if sequence_p:
                    last = vec[:, d]
                div *= n_mult
        else:
            last = np.zeros(self.entries)
            for d in range(self.dims):
                vec[:, d] = mult[np.arange(self.entries) * self.dims + d] \
                    * delta + minimum + last
                if sequence_p:
                    last = vec[:, d]
        self.vectors = vec

    def _build_lut(self) -> None:
        """Primary LUT over LUT_BITS of arrival-order bits; longer
        codewords fall back to a dict keyed (reversed_prefix, length)."""
        k = self.LUT_BITS
        self.lut_entry = np.full(1 << k, -1, np.int32)
        self.lut_len = np.zeros(1 << k, np.uint8)
        self.long_codes: dict[tuple[int, int], int] = {}
        self.max_len = 1
        for entry, code in self._codes.items():
            l = self.lengths[entry] if self._single is None \
                else self._single[1]
            self.max_len = max(self.max_len, l)
            rev = _reverse_bits(code, l)
            if l <= k:
                step = 1 << l
                for base in range(rev, 1 << k, step):
                    self.lut_entry[base] = entry
                    self.lut_len[base] = l
            else:
                self.long_codes[(rev, l)] = entry

    def decode(self, br: LsbBitReader) -> int:
        if self._single is not None:
            br.read(self._single[1])
            return self._single[0]
        w = br.peek(self.max_len)
        idx = w & ((1 << self.LUT_BITS) - 1)
        e = self.lut_entry[idx]
        if e >= 0:
            need = int(self.lut_len[idx])
            if br.bits_left < need:
                from .bitreader import EndOfPacket
                raise EndOfPacket
            br.pos += need
            return int(e)
        for l in range(self.LUT_BITS + 1, self.max_len + 1):
            ent = self.long_codes.get((w & ((1 << l) - 1), l))
            if ent is not None:
                if br.bits_left < l:
                    from .bitreader import EndOfPacket
                    raise EndOfPacket
                br.pos += l
                return ent
        raise VorbisError("invalid codeword")

    def decode_vq(self, br: LsbBitReader) -> np.ndarray:
        if self.vectors is None:
            raise VorbisError("scalar book used for VQ")
        return self.vectors[self.decode(br)]
