"""Vorbis header packets: identification, comment, setup (codebooks,
floors, residues, mappings, modes).

Spec §4.2; behavioural parity: Tremor info.c + the component _unpack
routines (floor1.c, res012.c, mapping0.c).  Floor 0 (legacy LSP) is
parsed but decode is unsupported — no modern encoder emits it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitreader import LsbBitReader, ilog
from .codebook import Codebook, VorbisError


@dataclass(slots=True)
class VorbisInfo:
    channels: int
    sample_rate: int
    bitrate_max: int
    bitrate_nominal: int
    bitrate_min: int
    blocksize: tuple          # (short, long)


def parse_identification(packet: bytes) -> VorbisInfo:
    if packet[:7] != b"\x01vorbis":
        raise VorbisError("not an identification header")
    br = LsbBitReader(packet[7:])
    if br.read(32) != 0:
        raise VorbisError("unknown vorbis version")
    channels = br.read(8)
    rate = br.read(32)
    br_max, br_nom, br_min = br.read(32), br.read(32), br.read(32)
    bs0 = 1 << br.read(4)
    bs1 = 1 << br.read(4)
    if not (64 <= bs0 <= bs1 <= 8192) or not br.read_bit():
        raise VorbisError("bad blocksizes / framing")
    if channels == 0 or rate == 0:
        raise VorbisError("bad id header")
    return VorbisInfo(channels, rate, br_max, br_nom, br_min, (bs0, bs1))


def parse_comment(packet: bytes) -> tuple[str, dict]:
    if packet[:7] != b"\x03vorbis":
        raise VorbisError("not a comment header")
    p = 7
    vl = int.from_bytes(packet[p:p + 4], "little")
    p += 4
    vendor = packet[p:p + vl].decode("utf-8", "replace")
    p += vl
    n = int.from_bytes(packet[p:p + 4], "little")
    p += 4
    tags: dict = {}
    for _ in range(n):
        ln = int.from_bytes(packet[p:p + 4], "little")
        p += 4
        item = packet[p:p + ln].decode("utf-8", "replace")
        p += ln
        k, _, v = item.partition("=")
        tags.setdefault(k.upper(), []).append(v)
    return vendor, tags


@dataclass(slots=True)
class Floor1:
    partitions: int
    partition_classes: list
    class_dims: list
    class_subclasses: list
    class_masterbooks: list
    subclass_books: list      # [class][subclass] -> book index or -1
    multiplier: int
    x_list: list              # posts in transmission order (incl. 0, 2^r)
    sort_order: list          # indices sorting x_list ascending
    neighbors: list           # (low, high) per post >= 2


@dataclass(slots=True)
class Floor0:
    order: int
    rate: int
    bark_map_size: int
    amplitude_bits: int
    amplitude_offset: int
    books: list


@dataclass(slots=True)
class Residue:
    kind: int                 # 0, 1, 2
    begin: int
    end: int
    partition_size: int
    classifications: int
    classbook: int
    books: list               # [classification][pass] -> book or -1


@dataclass(slots=True)
class Mapping:
    submaps: int
    coupling: list            # (magnitude_ch, angle_ch)
    mux: list                 # channel -> submap
    submap_floor: list
    submap_residue: list


@dataclass(slots=True)
class Mode:
    blockflag: int
    mapping: int


@dataclass(slots=True)
class Setup:
    codebooks: list = field(default_factory=list)
    floors: list = field(default_factory=list)       # (kind, obj)
    residues: list = field(default_factory=list)
    mappings: list = field(default_factory=list)
    modes: list = field(default_factory=list)


def _parse_floor1(br: LsbBitReader) -> Floor1:
    partitions = br.read(5)
    partition_classes = [br.read(4) for _ in range(partitions)]
    maxclass = max(partition_classes) if partition_classes else -1
    class_dims, class_sub, class_master, sub_books = [], [], [], []
    for _ in range(maxclass + 1):
        class_dims.append(br.read(3) + 1)
        sub = br.read(2)
        class_sub.append(sub)
        class_master.append(br.read(8) if sub else -1)
        sub_books.append([br.read(8) - 1 for _ in range(1 << sub)])
    multiplier = br.read(2) + 1
    rangebits = br.read(4)
    x_list = [0, 1 << rangebits]
    for i in range(partitions):
        cls = partition_classes[i]
        for _ in range(class_dims[cls]):
            x_list.append(br.read(rangebits))
    if len(set(x_list)) != len(x_list) or len(x_list) > 65:
        raise VorbisError("bad floor1 x_list")
    sort_order = sorted(range(len(x_list)), key=lambda i: x_list[i])
    # low/high neighbors (spec §9.2.4/5): nearest preceding posts with
    # smaller/greater x
    neighbors = []
    for i in range(2, len(x_list)):
        lo = 0
        hi = 1
        for j in range(i):
            if x_list[lo] < x_list[j] < x_list[i]:
                lo = j
            if x_list[i] < x_list[j] < x_list[hi]:
                hi = j
        neighbors.append((lo, hi))
    return Floor1(partitions, partition_classes, class_dims, class_sub,
                  class_master, sub_books, multiplier, x_list, sort_order,
                  neighbors)


def _parse_floor0(br: LsbBitReader) -> Floor0:
    order = br.read(8)
    rate = br.read(16)
    bark = br.read(16)
    amp_bits = br.read(6)
    amp_off = br.read(8)
    nbooks = br.read(4) + 1
    books = [br.read(8) for _ in range(nbooks)]
    return Floor0(order, rate, bark, amp_bits, amp_off, books)


def _parse_residue(br: LsbBitReader, kind: int, n_books: int) -> Residue:
    begin = br.read(24)
    end = br.read(24)
    psize = br.read(24) + 1
    classifications = br.read(6) + 1
    classbook = br.read(8)
    cascades = []
    for _ in range(classifications):
        low = br.read(3)
        bitflag = br.read_bit()
        high = br.read(5) if bitflag else 0
        cascades.append((high << 3) | low)
    books = []
    for c in range(classifications):
        row = []
        for p in range(8):
            if cascades[c] & (1 << p):
                b = br.read(8)
                if b >= n_books:
                    raise VorbisError("bad residue book")
                row.append(b)
            else:
                row.append(-1)
        books.append(row)
    return Residue(kind, begin, end, psize, classifications, classbook,
                   books)


def _parse_mapping(br: LsbBitReader, channels: int, n_floors: int,
                   n_residues: int) -> Mapping:
    if br.read(16) != 0:
        raise VorbisError("bad mapping type")
    submaps = br.read(4) + 1 if br.read_bit() else 1
    coupling = []
    if br.read_bit():
        steps = br.read(8) + 1
        bits = ilog(channels - 1)
        for _ in range(steps):
            m = br.read(bits)
            a = br.read(bits)
            if m == a or m >= channels or a >= channels:
                raise VorbisError("bad coupling")
            coupling.append((m, a))
    if br.read(2) != 0:
        raise VorbisError("reserved mapping bits")
    if submaps > 1:
        mux = [br.read(4) for _ in range(channels)]
    else:
        mux = [0] * channels
    floors, residues = [], []
    for _ in range(submaps):
        br.read(8)                       # unused time config
        f = br.read(8)
        r = br.read(8)
        if f >= n_floors or r >= n_residues:
            raise VorbisError("bad submap")
        floors.append(f)
        residues.append(r)
    return Mapping(submaps, coupling, mux, floors, residues)


def parse_setup(packet: bytes, channels: int) -> Setup:
    if packet[:7] != b"\x05vorbis":
        raise VorbisError("not a setup header")
    br = LsbBitReader(packet[7:])
    s = Setup()
    for _ in range(br.read(8) + 1):
        s.codebooks.append(Codebook(br))
    for _ in range(br.read(6) + 1):      # time transforms (placeholders)
        if br.read(16) != 0:
            raise VorbisError("bad time transform")
    for _ in range(br.read(6) + 1):
        kind = br.read(16)
        if kind == 1:
            s.floors.append((1, _parse_floor1(br)))
        elif kind == 0:
            s.floors.append((0, _parse_floor0(br)))
        else:
            raise VorbisError("bad floor type")
    for _ in range(br.read(6) + 1):
        kind = br.read(16)
        if kind > 2:
            raise VorbisError("bad residue type")
        s.residues.append(_parse_residue(br, kind, len(s.codebooks)))
    for _ in range(br.read(6) + 1):
        s.mappings.append(_parse_mapping(br, channels, len(s.floors),
                                         len(s.residues)))
    for _ in range(br.read(6) + 1):
        blockflag = br.read_bit()
        if br.read(16) != 0 or br.read(16) != 0:   # window/transform type
            raise VorbisError("bad mode")
        mapping = br.read(8)
        if mapping >= len(s.mappings):
            raise VorbisError("bad mode mapping")
        s.modes.append(Mode(blockflag, mapping))
    if not br.read_bit():
        raise VorbisError("setup framing error")
    return s
