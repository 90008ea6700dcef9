"""Residue decode, formats 0/1/2 (spec §8.6; parity: Tremor res012.c).

Format 2 interleaves all channels into one vector; 0/1 run per channel.
End-of-packet mid-residue is a normal termination (partial spectrum
stands, spec §1.3.2).

The per-symbol Huffman/VQ walk runs in the native helper
(native/vorbis_core.cc) — the bit-serial hot loop the reference keeps in
Tremor's res012.c/codebook.c.  In the port the packet decoder always passes
the native context; the bit-for-bit-identical Python walk (``native=None``)
is kept as its oracle."""

from __future__ import annotations

import numpy as np

from .bitreader import EndOfPacket, LsbBitReader
from .codebook import VorbisError
from .headers import Residue


def decode_residue(br: LsbBitReader, res: Residue, books: list,
                   do_not_decode: list[bool], n: int,
                   native=None) -> list[np.ndarray]:
    """Decode one residue for `len(do_not_decode)` channels of n samples
    (n = blocksize/2).  Returns per-channel float vectors."""
    ch = len(do_not_decode)
    if res.kind == 2:
        if native is not None:
            combined = _decode_native(br, res, native, [False], ch * n) \
                if not all(do_not_decode) else np.zeros((1, ch * n))
            combined = combined[0]
        else:
            combined = np.zeros(ch * n, np.float64)
            if not all(do_not_decode):
                _decode_vectors(br, res, books, [combined], [False],
                                ch * n)
        # deinterleave
        return [np.ascontiguousarray(combined[c::ch]) for c in range(ch)]
    if native is not None:
        out = _decode_native(br, res, native, do_not_decode, n)
        return list(out)
    vectors = [np.zeros(n, np.float64) for _ in range(ch)]
    _decode_vectors(br, res, books, vectors, do_not_decode, n)
    return vectors


def _decode_native(br: LsbBitReader, res: Residue, native,
                   dnd: list[bool], n: int) -> np.ndarray:
    """Run one residue in native/vorbis_core.cc; raises VorbisError on
    an invalid codeword or a scalar book used for VQ, exactly like the
    Python walk below."""
    nvec = len(dnd)
    out = np.zeros((nvec, n), np.float64)
    status, newpos = native.residue_decode(
        br.data + b"\x00" * 8, br._len, br.pos, res.kind, res.begin,
        res.end, res.partition_size, res.classifications, res.classbook,
        np.ascontiguousarray(res.books, np.int32),
        np.array(dnd, np.uint8), out, n)
    br.pos = newpos
    if status:
        raise VorbisError("invalid codeword" if status == 2
                          else "scalar book used for VQ")
    return out


def _decode_vectors(br: LsbBitReader, res: Residue, books: list,
                    vectors: list[np.ndarray], dnd: list[bool],
                    n: int) -> None:
    begin = min(res.begin, n)
    end = min(res.end, n)
    if end <= begin:
        return
    psize = res.partition_size
    to_read = (end - begin) // psize
    if to_read == 0:
        return
    classbook = books[res.classbook]
    cw = classbook.dims
    nvec = len(vectors)
    classif = np.zeros((nvec, to_read + cw), np.int32)
    try:
        for p in range(8):
            pc = 0
            while pc < to_read:
                if p == 0:
                    for j in range(nvec):
                        if dnd[j]:
                            continue
                        temp = classbook.decode(br)
                        for i in range(cw - 1, -1, -1):
                            classif[j, pc + i] = temp % res.classifications
                            temp //= res.classifications
                for _ in range(cw):
                    if pc >= to_read:
                        break
                    for j in range(nvec):
                        if dnd[j]:
                            continue
                        book_i = res.books[classif[j, pc]][p]
                        if book_i >= 0:
                            _decode_partition(
                                br, res.kind, books[book_i], vectors[j],
                                begin + pc * psize, psize)
                    pc += 1
    except EndOfPacket:
        return


def _decode_partition(br: LsbBitReader, kind: int, book, v: np.ndarray,
                      offset: int, psize: int) -> None:
    dims = book.dims
    if kind == 0:
        step = psize // dims
        for i in range(step):
            entry = book.decode_vq(br)
            v[offset + i:offset + i + dims * step:step] += entry
    else:                                # formats 1 and 2
        i = 0
        while i < psize:
            entry = book.decode_vq(br)
            v[offset + i:offset + i + dims] += entry
            i += dims
