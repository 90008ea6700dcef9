"""Entry points of the port (``__graft_entry__`` of the JAX package):
``entry``, the flagship step on one device, and ``dryrun_multichip``, real
decodes over a device mesh, each section held against the same work on one
device."""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from . import parallel

_ASSETS = pathlib.Path(__file__).resolve().parent.parent / "tests" / "assets"


def entry(device="cuda"):
    """-> (fn, args): the decode->render step and its example inputs as
    tensors on ``device`` (the card unless the caller asks for the CPU);
    ``fn(*args)`` returns (rendered, peaks)."""
    args = tuple(torch.from_numpy(a).to(device)
                 for a in parallel.example_step_args(nframes=8, n=1024))

    def fn(*a):
        return parallel.decode_render_step(*a, num_channels=2)

    return fn, args


def _asset(name: str) -> bytes:
    path = _ASSETS / name
    if not path.exists():
        # a lost asset must fail the dry run, not skip its section
        raise FileNotFoundError(f"dryrun asset missing: {path}")
    return path.read_bytes()


def _on(dev, *arrays) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _distinct(refs: list) -> None:
    if not any(not np.array_equal(refs[0], r) for r in refs[1:]):
        raise AssertionError("the shards' content is not distinct")


def _flac_section(mesh, ref, nch: int):
    """Real FLAC, encoded in process and parsed by the native unpacker:
    rows over dp (frame-aligned), bit-exact against one device and the
    encoder's input."""
    from ._host import encode_flac, native, parse_metadata
    from .codecs.flac import synthesise_group

    dp = mesh.shape["dp"]
    rate = 44100
    n = 1024 * 4 * max(2, dp)
    t = np.arange(n) / rate
    rng = np.random.default_rng(3)
    x = np.stack([np.rint(18000 * np.sin(2 * np.pi * 499 * t)
                          + 400 * rng.standard_normal(n)),
                  np.rint(15000 * np.sin(2 * np.pi * 907 * t))]) \
        .astype(np.int32)
    blob = encode_flac(x, rate, 16, blocksize=1024)
    meta = parse_metadata(blob)
    si = meta.streaminfo
    nfr, _, _, b = native.flac_parse_group(
        blob, meta.header_bytes * 8, sample_rate=si.sample_rate,
        bits_per_sample=si.bits_per_sample, max_blocksize=1024,
        channels=nch, max_frames=4 * max(2, dp))
    rows = [b[k][:nfr * nch] for k in ("data", "coeffs", "shift", "order",
                                        "wasted")]
    assign = b["assign"][:nfr]
    multi = []
    for d, fs in zip(mesh.rows(), parallel._blocks(nfr, dp)):
        rs = slice(fs.start * nch, fs.stop * nch)
        multi.append(synthesise_group(*_on(d, *(a[rs] for a in rows),
                                           assign[fs]), nch).cpu())
    multi = torch.cat(multi).numpy()
    single = synthesise_group(*_on(ref, *rows, assign), nch).cpu().numpy()
    np.testing.assert_array_equal(multi, single)
    want = x[:, :nfr * 1024].reshape(nch, nfr, 1024).transpose(1, 0, 2)
    np.testing.assert_array_equal(multi, want)       # bit-exact decode
    return nfr


def _aac_section(mesh, ref, nch: int) -> str:
    """Real AAC-LC (tests/assets/dryrun.aac) through the native unpacker:
    the group's frames over dp, each dp row dequantising and synthesising
    its frames with the overlap handed on from the row before (the JAX
    program's carry across its frame shards); its host-prepared side rows
    go to the row that holds their frame.  Within 0.02 of one device, and
    the same int16 PCM."""
    from ._host import aac_native
    from .codecs import aac
    from .codecs.aac import synthesis as asyn

    dp = mesh.shape["dp"]
    data = _asset("dryrun.aac")
    GA = 2 * dp * nch
    nfr, _, batch = aac_native().aac_parse_group(data, 0, channels=nch,
                                                 max_frames=GA)
    assert nfr == GA, (nfr, GA)
    prep = aac.prepare_device_group(batch, GA, nch, np.zeros(nch, np.int32))
    assert prep is not None
    perm, band = aac.cfg_tables(prep["cfg_map"])
    frame_keys = ("quant", "sf", "coded", "cfg_idx", "ms_flag")
    side_spec, side_row = prep["side_spec"], prep["side_row"]
    ov = np.zeros((nch, 1024), np.float32)

    def run(dev, fs, overlap):
        lo, hi = fs.start * nch, fs.stop * nch
        rows = np.where((side_row >= lo) & (side_row < hi), side_row - lo,
                        -1).astype(np.int32)
        quant, sf, coded, cfg_idx, ms_flag = (prep[k][fs]
                                              for k in frame_keys)
        args = _on(dev, quant.astype(np.int32), sf, coded, cfg_idx, perm,
                   band, ms_flag, side_spec, rows, prep["opidx"][fs])
        return asyn.dequant_filterbank(
            *args, overlap.to(dev),
            *asyn.filterbank_constants(device=dev))

    multi, carry = [], torch.from_numpy(ov)
    for d, fs in zip(mesh.rows(), parallel._blocks(GA, dp)):
        pcm, carry = run(d, fs, carry)
        multi.append(pcm.cpu())
    multi = torch.cat(multi).numpy()
    single = run(ref, slice(0, GA), torch.from_numpy(ov))[0].cpu().numpy()
    # only float32 reduction-order noise is tolerable: 2% of one 16-bit LSB,
    # and the rounded int16 output must be identical
    np.testing.assert_allclose(multi, single, atol=0.02, rtol=0)
    np.testing.assert_array_equal(
        np.clip(np.rint(multi), -32768, 32767),
        np.clip(np.rint(single), -32768, 32767))
    return (f"{GA} frames sharded T/dp, max|pcm|="
            f"{float(np.abs(multi).max()):.0f}")


def _he_section(mesh, ref, nch: int) -> str:
    """Real HE-AAC (tests/assets/dryrun_he.aac): the core decoded on the
    host, the SBR chain (``sbr.device_decode_group``, the ``sbr_env``
    kernel) on dp streams of DISTINCT frame windows, one a dp row, each
    held against its own decode on one device."""
    from ._host import aac_bitstream as BS
    from ._host import aac_sbr, sbr_native
    from .codecs.aac import _StreamState, decode_frames_float
    from .codecs.aac import sbr as sbrd
    from .host.codecs.flac.bitreader import BitReader

    S = mesh.shape["dp"]
    data = _asset("dryrun_he.aac")
    sbr_native()
    pos, hdr0, frames = 0, None, []
    while (h := BS.parse_adts_header(data, pos)) is not None \
            and pos + h.frame_bytes <= len(data):
        hdr0 = hdr0 or h
        br = BitReader(data, (pos + h.header_bytes) * 8)
        frames.append(BS.parse_raw_data_block(br, h.rate_index))
        pos += h.frame_bytes
    Fh = max(2, min(5, len(frames) // S))
    assert Fh * S <= len(frames), (Fh, S, len(frames))
    dec = aac_sbr.SbrDecoder(hdr0.sample_rate)
    st_core = _StreamState(nch)
    parsed = []
    for fr in frames[:Fh * S]:
        core = decode_frames_float([fr], st_core)
        payload, nbits, crc = fr.sbr
        chans, coupling = dec.parse_payload(payload, nbits, stereo=True,
                                            crc=crc)
        EQ = [dec.dequant(dec.header, chans[i].grid, chans[i].env,
                          chans[i].noise) for i in range(nch)]
        if coupling:
            a_ = EQ[0][2]
            (EL, QL), (ER, QR) = dec.unmap_coupled(
                EQ[0][0], EQ[0][1], chans[1].env, chans[1].noise, a_)
            EQ = [(EL, QL, a_), (ER, QR, a_)]
        parsed.append((core, chans, EQ))
    static = sbrd.SbrStatic(dec)
    st_host = aac_sbr.SbrChannelState()
    # each window's cond built in stream order, so the host counters carry
    # across the windows: every shard gets real, distinct content
    conds, pcms = [], []
    for s in range(S):
        w = parsed[s * Fh:(s + 1) * Fh]
        conds.append(sbrd.build_frame_cond(
            dec, st_host, static, [p[1][0] for p in w],
            [p[2][0][0] for p in w], [p[2][0][1] for p in w], s == 0))
        pcms.append(np.stack([p[0][0] for p in w]).astype(np.float32))

    def one(dev, s):
        cond = sbrd.cond_to_device({k: np.asarray(v)[None] for k, v in
                                    vars(conds[s]).items()}, dev)
        state = sbrd.state_to_device(
            [sbrd.device_init_state(static.M)], dev)
        out, _ = sbrd.device_decode_group(
            static, torch.from_numpy(pcms[s][None]).to(dev), cond, state)
        return out[0].cpu().numpy()

    multi = [one(d, s) for s, d in enumerate(mesh.rows())]
    refs = [one(ref, s) for s in range(S)]
    peak = max(1.0, *(float(np.abs(r).max()) for r in refs))
    err = max(float(np.abs(m - r).max()) for m, r in zip(multi, refs))
    assert err <= 1e-3 * peak, (err, peak)
    if S > 1:
        _distinct(refs)
    return (f"{Fh * S} frames as {S} DISTINCT dp-sharded {Fh}-frame "
            f"streams through the device SBR chain, each vs its own "
            f"single-device decode, max err {err:.2e} (peak {peak:.0f})")


def _celt_section(mesh, ref):
    """Real Opus/CELT (tests/assets/dryrun.opus): entropy on the host, the
    synthesis (``celt.device_decode_group``, the ``celt_comb`` kernel) on
    dp DISTINCT frame windows, one a dp row, each equal to its own decode
    on one device; window 0 also equal to the whole-stream device decode.
    Returns (the whole-stream decode, the note)."""
    from .codecs.opus import celt

    S = mesh.shape["dp"]
    data = _asset("dryrun.opus")
    ch, gen = celt._open_capture(data)
    try:
        caps = list(gen)
    finally:
        gen.close()
    Fc = len(caps) // S
    assert Fc >= 2, (len(caps), S)
    packs = [celt.pack_captures(caps[s * Fc:(s + 1) * Fc], ch)
             for s in range(S)]

    def one(dev, s):
        X, gains, op, Tv, gt = packs[s]
        Xt, gt_, Tvt, gtt = _on(dev, X[None], gains[None], Tv[None],
                                gt[None])
        pcm16, _ = celt.device_decode_group(
            celt.device_static(dev), Xt, gt_, op[None], Tvt, gtt,
            celt.init_state(1, ch, dev))
        return pcm16[0].cpu().numpy()

    multi = [one(d, s) for s, d in enumerate(mesh.rows())]
    refs = [one(ref, s) for s in range(S)]
    for m, r in zip(multi, refs):
        np.testing.assert_array_equal(m, r)
    if S > 1:
        _distinct(refs)
    full = celt.decode_celt_stream_device(data, group=Fc, device=ref)
    np.testing.assert_array_equal(
        refs[0].transpose(1, 0, 2).reshape(ch, -1),
        full[:, :Fc * celt.N_FRAME])
    return full, (f"{Fc * S} frames as {S} DISTINCT dp-sharded {Fc}-frame "
                  f"streams, each == its own single-device int16 decode")


def _vorbis_section(mesh, ref) -> str:
    """Vorbis: dp DISTINCT seeded streams (their own seeds and window
    sequences), one a dp row, through ``device.group_step``, each within 1
    LSB of its own whole-stream decode on one device."""
    from ._host import vorbis_encoder
    from .codecs.vorbis import device as vdev

    S = mesh.shape["dp"]
    spec = vorbis_encoder.StreamSpec(channels=2, sample_rate=44100, bs0=256,
                                     bs1=1024, coupling=True)
    datas = []
    for s in range(S):
        rng = np.random.default_rng(500 + s)
        blocks = []
        for _ in range(24):
            lng = int(rng.random() < 0.7)
            half = 512 if lng else 128
            r = np.zeros((2, half), np.int64)
            msk = rng.random((2, half)) < 0.3
            r[msk] = rng.integers(-2, 3, msk.sum())
            blocks.append((lng, [(140, 120)] * 2, r))
        datas.append(spec.build(blocks))
    caps = [vdev.capture_stream(d) for d in datas]
    bs0, bs1 = caps[0][0].blocksize
    half1 = bs1 // 2
    G = len(caps[0][1])
    assert all(len(c) == G for _, c in caps)
    for s, ((_info, blocks), d) in enumerate(zip(caps, mesh.rows())):
        Xq, sc, oh, lo, cen, _pq, st = vdev._pack_group(blocks, None, bs0,
                                                        bs1, 2, G)
        shift = cen - st
        Xt, sct, lot, sht = _on(d, Xq[None], sc[None],
                                (lo - (st - half1))[None],
                                np.array([shift], np.int64))
        pcm16, _ = vdev.group_step(
            vdev.device_operators(bs0, bs1, d), Xt, sct, oh[None], lot, sht,
            torch.zeros((1, 2, half1), device=d))
        got = pcm16[0, :, half1:half1 + shift].cpu().numpy()
        single = vdev.decode_vorbis_stream_device(datas[s], group=G,
                                                  device=ref)
        assert got.shape == single.shape, (got.shape, single.shape)
        assert np.abs(got.astype(np.int32) - single).max() <= 1
    if S > 1:
        _distinct(datas)
    return (f"{G} mixed-window blocks x {S} DISTINCT dp-sharded streams "
            f"(per-stream seeds + window sequences), each == its own "
            f"single-device decode within 1 LSB")


def _mp3_section(mesh, ref) -> str:
    """MP3: host entropy decode and prep, the scan-free hybrid filterbank
    (``synthesis.hybrid_synthesis_parallel``, the ``mp3_window`` kernel) on
    dp DISTINCT seeded spectra, one a dp row, each within 1 LSB of its own
    decode on one device."""
    from ._host import mp3_bitstream, mp3_encoder, mp3_prep
    from .codecs.mp3 import synthesis as msyn

    S = mesh.shape["dp"]
    wires, n_real = [], None
    for s in range(S):
        rng = np.random.default_rng(900 + s)
        spec = np.zeros((2, 576), np.int32)
        mask = rng.random((2, 576)) < 0.25
        spec[mask] = rng.integers(1, 12, mask.sum())
        stream = mp3_bitstream.Mp3Stream(
            mp3_encoder.build_stream([spec[0], spec[1]], nframes=16))
        frames = []
        while (fr := stream.next_frame()) is not None:
            frames.append(fr)
        xr, bt = mp3_prep.prepare_granules(frames, 2)
        xr, bt = xr.astype(np.float32), bt.astype(np.int32)
        assert n_real in (None, xr.shape[0])
        n_real = xr.shape[0]
        tg = max(32, 1 << (n_real - 1).bit_length())
        wires.append((np.concatenate([xr, np.zeros((tg - n_real, 2, 576),
                                                   np.float32)]),
                      np.concatenate([bt, np.zeros((tg - n_real, 2, 32),
                                                   np.int32)])))

    def one(dev, s):
        xr, bt = _on(dev, *wires[s])
        ov, vf = msyn.init_state(2, dev)
        pcm, _, _ = msyn.hybrid_synthesis_parallel(xr, bt, ov, vf, n_real)
        return pcm.cpu().numpy().astype(np.int64)

    refs = [one(ref, s) for s in range(S)]
    for s, d in enumerate(mesh.rows()):
        assert np.abs(one(d, s) - refs[s]).max() <= 1
    if S > 1:
        _distinct(refs)
    return (f"{n_real} granules x {S} DISTINCT dp-sharded streams "
            f"(per-stream spectra) through the parallel hybrid filterbank, "
            f"each == its own single-device decode within 1 LSB")


def _serving_section(mesh, ref) -> str:
    """The public serving calls with ``mesh=`` (the stream blocks over dp),
    each against the same call with ``mesh=None`` on one device: FLAC
    bit-exact, MP3 within the JAX dry run's 24 LSB."""
    from ._host import encode_flac, mp3_encoder
    from .codecs.flac.serving import decode_flac_streams_device
    from .codecs.mp3.serving import decode_mp3_streams_device

    rate = 44100
    t = np.arange(6144) / rate
    flac = []
    for s in range(4):
        x = np.stack([np.rint(9000 * np.sin(2 * np.pi * (311 + 61 * s) * t)),
                      np.rint(7000 * np.sin(2 * np.pi * (457 + 37 * s) * t))]
                     ).astype(np.int32)
        flac.append(encode_flac(x, rate, 16, blocksize=1024))
    want = decode_flac_streams_device(flac, 4, device=ref)
    got = decode_flac_streams_device(flac, 4, mesh=mesh)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    rng = np.random.default_rng(17)
    mp3 = []
    for s in range(4):
        frames = []
        for _ in range(8 + 3 * s):
            spec = np.zeros((2, 576), np.int32)
            mask = rng.random((2, 576)) < 0.2
            spec[mask] = rng.integers(1, 11, mask.sum())
            frames.append(mp3_encoder.build_frame([spec[0], spec[1]],
                                                  global_gain=178))
        mp3.append(b"".join(frames))
    want = decode_mp3_streams_device(mp3, 8, device=ref)
    got = decode_mp3_streams_device(mp3, 8, mesh=mesh)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        assert np.abs(g.astype(np.int64) - w).max() <= 24
    return ("public serving APIs on the mesh: "
            "decode_flac_streams_device(mesh=) bit-exact, "
            "decode_mp3_streams_device(mesh=) within LSBs "
            "(decode_aac/he_streams_device(mesh=) covered by "
            "tests/test_torch_serving_mesh.py)")


def dryrun_multichip(n_devices: int | None = None, *, devices=None) -> str:
    """Decode real encoded streams over a mesh of ``n_devices`` cards, or
    of the named ``devices`` (``parallel.make_mesh``; with no card and no
    list it raises, and it never falls back to the CPU).  Every section is
    held against the same work on one device (the mesh's first): FLAC rows
    over dp, bit-exact and equal to the encoder's input; AAC-LC frames over
    dp; HE-AAC SBR, CELT, Vorbis and MP3 device passes on distinct streams,
    one a dp row; the serving calls with ``mesh=``; the room fan-out of the
    CELT decode to every device; and the per-room render grid.  Raises on
    the first disagreement; prints and returns one summary line."""
    mesh = parallel.make_mesh(n_devices, devices=devices)
    ref = mesh.devices[0, 0]
    nch = 2
    nfr = _flac_section(mesh, ref, nch)
    aac_note = _aac_section(mesh, ref, nch)
    he_note = _he_section(mesh, ref, nch)
    celt_full, celt_note = _celt_section(mesh, ref)
    vorbis_note = _vorbis_section(mesh, ref)
    mp3_note = _mp3_section(mesh, ref)
    serving_note = _serving_section(mesh, ref)

    # the room fan-out of real decoded audio: the CELT tiles split over dp,
    # gathered so that every device ("room") holds the whole master mix
    tiles = celt_full.astype(np.float32)
    full, peak = parallel.room_fanout(mesh, tiles)
    rooms = [t.cpu().numpy() for _, _, t in full.shards]
    assert len(rooms) == mesh.size
    for room in rooms:
        np.testing.assert_array_equal(room, tiles)
    assert float(peak) > 0

    # every room's receiver chain: fractional delay, clock-skew resample,
    # ramp x gain, the rooms split over dp
    n_rooms = mesh.shape["dp"]
    master = tiles[:min(2, tiles.shape[0])]
    gains = np.linspace(0.25, 1.0, n_rooms).astype(np.float32)
    delays = (np.arange(n_rooms) * 2.5).astype(np.float32)
    skew = np.linspace(-150.0, 150.0, n_rooms).astype(np.float32)
    skew[0] = 0.0                       # room 0: the unity chain below
    grid = parallel.room_render_grid(mesh, master, gains, delays, skew,
                                     np.ones(n_rooms, np.float32),
                                     np.ones(n_rooms, np.float32))
    assert grid.devices == mesh.rows()    # the rooms live on the dp rows
    per_room = grid.full("cpu").numpy()
    assert per_room.shape == (n_rooms, *master.shape)
    np.testing.assert_allclose(per_room[0], master * gains[0], rtol=5e-3,
                               atol=1e-2)
    if n_rooms > 1:
        assert np.all(per_room[1][:, :2] == 0.0)  # a delayed room: silent

    line = (f"dryrun_multichip ok: mesh {tuple(mesh.devices.shape)} axes "
            f"{mesh.axis_names} on {[str(d) for d in mesh.flat()]}; FLAC "
            f"{nfr} frames bit-exact sharded decode; AAC {aac_note}; HE-AAC "
            f"{he_note}; CELT {celt_note}; Vorbis {vorbis_note}; MP3 "
            f"{mp3_note}; {serving_note}; room fan-out to {len(rooms)} "
            f"devices + per-room render grid ({n_rooms} receiver chains, "
            f"delay/skew/gain) verified")
    print(line)
    return line
