"""The port's other codec plug-ins on the CPU, against the JAX package.

Through the render path (the port's ``PipelineManager("cpu")`` against the
JAX pipeline, as tests/test_torch_pipeline.py plays them): ``CodecMp3`` on
CBR, MPEG-2 LSF, a stream whose last group is one frame and a Xing stream
(<= 1 LSB); ``CodecAacMp4`` on AAC-LC (<= 1 LSB) and on HE-AAC with implicit
and explicit signalling (<= 2 LSB, and <= 1 LSB of the port's own
``decode_adts`` of the same frames); the host plug-ins (Vorbis, Opus in Ogg
and MP4, ALAC escape frames, seeded SILK-mode Opus) equal.  Below it: MP3
and M4A seeks, ``parse_audio_specific_config``, the SBR runner's PCM-mode
methods, the SILK decoder on its native and Python paths and the ALAC
decoder on hostile packets, each against the JAX package.  The repository
holds no ALAC or SILK encoder, so ALAC is held on escape (verbatim) frames
and SILK on seeded packets, which the range decoder reads as SILK
parameters."""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.codecs import aac as aac_codec
from ohpipeline_tpu_torch.codecs import mp3 as mp3_codec
from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
from ohpipeline_tpu_torch.host import native
from ohpipeline_tpu_torch.host.codecs import alac as AL
from ohpipeline_tpu_torch.host.codecs import opus as opus_codec
from ohpipeline_tpu_torch.host.codecs.base import BufferReader
from ohpipeline_tpu_torch.host.containers.mpeg4 import find_audio_track
from ohpipeline_tpu_torch.host.core.jiffies import Jiffies
from test_torch_pipeline import _jax_play, _play, watchdog

MP3_CONTENT = {
    "cbr": lambda: chip_smoke.mp3_bench_stream(0, 2.0),
    "lsf": lambda: chip_smoke.mp3_block_stream(50, 40, lsf=True),
    # 33 frames: two groups of 16, then a group of one frame
    "short_tail": lambda: chip_smoke.mp3_block_stream(41, 33),
    "xing": lambda: chip_smoke.mp3_with_xing(
        chip_smoke.mp3_bench_stream(0, 2.0)),
}
M4A_CONTENT = {
    "lc": lambda: chip_smoke.m4a_from_adts(chip_smoke.AAC_ASSET),
    "he_implicit": lambda: chip_smoke.m4a_from_adts(chip_smoke.HE_ASSET,
                                                    False),
    "he_explicit": lambda: chip_smoke.m4a_from_adts(chip_smoke.HE_ASSET,
                                                    True),
}


def _opus() -> bytes:
    with open(chip_smoke.CELT_ASSET, "rb") as f:
        return f.read()


HOST_CONTENT = {
    "vorbis": lambda: chip_smoke.vorbis_stream(0, "mixed", 2.0),
    "opus": _opus,
    "opus_mp4": lambda: chip_smoke.opus_mp4(_opus()),
    "alac": lambda: chip_smoke.alac_escape_stream(0)[0],
    "silk": lambda: chip_smoke.opus_ogg(chip_smoke.silk_packets(0)),
}


@functools.lru_cache(maxsize=None)
def _content(kind: str) -> bytes:
    return {**MP3_CONTENT, **M4A_CONTENT, **HOST_CONTENT}[kind]()


def _uri(tmp_path, kind: str) -> str:
    path = tmp_path / kind
    path.write_bytes(_content(kind))
    return f"file://{path}"


def _info(info) -> tuple:
    return (info.codec_name, info.sample_rate, info.num_channels,
            info.bit_depth, info.lossless, info.seekable,
            info.track_length_jiffies)


def _lsb(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(np.asarray(a, np.int64) - b).max())


def _against_jax(tmp_path, kind: str, lsb_max: int):
    uri = _uri(tmp_path, kind)
    port, jax = _play(uri), _jax_play(uri)
    assert port.pcm.any()
    assert [_info(i) for i in port.infos] == [_info(i) for i in jax.infos]
    lsb = _lsb(port.pcm, jax.pcm)
    assert lsb <= lsb_max, lsb
    return port


# --- through the render path ---------------------------------------------

@pytest.mark.parametrize("kind", list(MP3_CONTENT))
def test_mp3_matches_the_jax_pipeline(tmp_path, kind):
    port = _against_jax(tmp_path, kind, 1)
    assert port.infos[0].codec_name == "MP3"


@pytest.mark.parametrize("kind,lsb_max", [("lc", 1), ("he_implicit", 2),
                                          ("he_explicit", 2)])
def test_m4a_matches_the_jax_pipeline(tmp_path, kind, lsb_max):
    port = _against_jax(tmp_path, kind, lsb_max)
    assert port.infos[0].codec_name == ("AAC" if kind == "lc" else "HE-AAC")


@pytest.mark.parametrize("kind", ["he_implicit", "he_explicit"])
def test_m4a_he_is_the_ports_adts_decode(tmp_path, kind):
    """The MP4 plug-in parses its frames with the Python parser and the
    ADTS one with the native unpacker; both share the SBR runner, and the
    order of the spectral prep's sums moves isolated samples by 1 LSB
    (tests/test_sbr.py:283-290 holds the JAX package the same way)."""
    port = _play(_uri(tmp_path, kind))
    with open(chip_smoke.HE_ASSET, "rb") as f:
        _info_adts, ref = aac_codec.decode_adts(f.read(), device="cpu")
    assert _lsb(port.pcm, ref) <= 1


@pytest.mark.parametrize("kind", list(HOST_CONTENT))
def test_host_plugins_match_the_jax_pipeline(tmp_path, kind):
    _against_jax(tmp_path, kind, 0)


def test_alac_escape_frames_play_their_input(tmp_path):
    m4a, pcm = chip_smoke.alac_escape_stream(0)
    path = tmp_path / "t.m4a"
    path.write_bytes(m4a)
    sink = _play(f"file://{path}")
    assert sink.infos[0].codec_name == "ALAC" and sink.infos[0].lossless
    np.testing.assert_array_equal(sink.pcm, pcm)


def test_opus_mp4_is_the_ports_ogg_decode():
    ogg = _content("opus")
    _info_o, pcm_ogg = opus_codec.decode_opus(ogg)
    info_m, pcm_mp4 = opus_codec.decode_opus_mp4(_content("opus_mp4"))
    assert info_m.codec_name == "Opus" and pcm_ogg.any()
    # the containers may trim the end differently (Ogg granule against the
    # mdhd duration) by less than one packet
    n = min(pcm_ogg.shape[1], pcm_mp4.shape[1])
    assert abs(pcm_ogg.shape[1] - pcm_mp4.shape[1]) < 960
    np.testing.assert_array_equal(pcm_ogg[:, :n], pcm_mp4[:, :n])


# --- below the render path -----------------------------------------------

def _jax_run(codec, data, seek=None):
    from ohpipeline_tpu.codecs.base import EndOfStream
    return chip_smoke.plugin_run(codec, data, seek, eos=EndOfStream)


def _same_runs(port, jax, lsb_max: int) -> None:
    assert [o for o, _ in port[1]] == [o for o, _ in jax[1]]
    assert max(_lsb(a, b) for (_, a), (_, b) in zip(port[1], jax[1])) \
        <= lsb_max


@pytest.mark.parametrize("kind", ["cbr", "xing"])
def test_mp3_seek_matches_jax(kind):
    """try_seek's byte targets (the CBR frame position, or the Xing TOC's
    interpolation) equal the JAX plug-in's, and a decode that seeks after
    3 groups restarts where the JAX one does: the group in flight is
    dropped and the stream and its device state start anew at the
    target."""
    from ohpipeline_tpu.codecs.mp3 import CodecMp3 as JaxMp3

    data = _content(kind)
    port, jax = mp3_codec.CodecMp3(device="cpu"), JaxMp3()
    info = port.stream_initialise(BufferReader(data))
    jax.stream_initialise(BufferReader(data))
    total = info.track_length_jiffies // Jiffies.per_sample(
        info.sample_rate)
    assert total > 80000
    for sample in (0, 1, 1151, 1152, total // 3, total // 2, total - 1):
        assert port.try_seek(sample) == jax.try_seek(sample), sample
    target = 22050                        # back into the second group
    runs = (chip_smoke.plugin_run(mp3_codec.CodecMp3(device="cpu"), data,
                                  (3, target)),
            _jax_run(JaxMp3(), data, (3, target)))
    _same_runs(*runs, 1)
    offsets = [o for o, _ in runs[0][1]]
    assert offsets[3] == target // 1152 * 1152 < offsets[2]


def test_m4a_lc_seek_matches_jax():
    from ohpipeline_tpu.codecs.aac import CodecAacMp4 as JaxMp4

    data = _content("lc")
    for sample in (0, 1024, 40000, 61000):
        runs = (chip_smoke.plugin_run(aac_codec.CodecAacMp4(device="cpu"),
                                      data, (1, sample)),
                _jax_run(JaxMp4(), data, (1, sample)))
        _same_runs(*runs, 1)
        assert runs[0][1][1][0] == sample // 1024 * 1024


def _asc(bits: str) -> bytes:
    bits = bits.replace(" ", "")
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


@pytest.mark.parametrize("error", [
    _kernels.KernelError("sbr_env kernel launch failed: CUDA error 700"),
    ValueError("hostile SBR payload")])
def test_m4a_probes_raise_a_device_fault_and_nothing_else(monkeypatch,
                                                          error):
    """The JAX plug-in's probes swallow every error: recognise() reads
    False, the SBR probe of stream_initialise() decodes the core as plain
    AAC-LC.  The port's do the same, except for a device fault, which
    goes up to the controller (and from there to the animator's caller)
    instead of becoming a silent LC decode."""
    from ohpipeline_tpu_torch.host.containers import mpeg4

    data = _content("he_implicit")

    def boom(*args, **kwargs):
        raise error

    monkeypatch.setattr(aac_codec.SBR, "SbrDecoder", boom)
    codec = aac_codec.CodecAacMp4(device="cpu")
    if isinstance(error, _kernels.KernelError):
        with pytest.raises(_kernels.KernelError):
            codec.stream_initialise(BufferReader(data))
    else:
        info = codec.stream_initialise(BufferReader(data))
        assert info.codec_name == "AAC" and info.sample_rate == 22050
    monkeypatch.setattr(mpeg4, "find_audio_track", boom)
    if isinstance(error, _kernels.KernelError):
        with pytest.raises(_kernels.KernelError):
            codec.recognise(data)
    else:
        assert codec.recognise(data) is False


#: AudioSpecificConfigs (AOT, rate index, channels[, extension rate index,
#: core AOT]); the last four are rejected or cut short
ASC_CASES = {
    "lc": bytes([0x12, 0x10]),
    "he_explicit": chip_smoke.aac_asc(7, 2, sbr=True),
    "he_v2_mono": _asc("11101 0111 0001 0100 00010"),
    "ext_rate_escape": _asc("00101 0111 0010 1111" + f"{44100:024b}"
                            + "00010"),
    "main_profile": _asc("00001 0100 0010"),
    "he_over_main": _asc("00101 0111 0010 0100 00001"),
    "explicit_rate": _asc("00010 1111" + f"{44100:024b}" + "0010"),
    "truncated": bytes([0x12]),
}


@pytest.mark.parametrize("name", list(ASC_CASES))
def test_parse_audio_specific_config_matches_jax(name):
    from ohpipeline_tpu.codecs.aac import parse_audio_specific_config as jax

    def outcome(fn):
        try:
            return fn(ASC_CASES[name])
        except Exception as exc:                        # noqa: BLE001
            return type(exc).__name__

    got = outcome(aac_codec.parse_audio_specific_config)
    assert got == outcome(jax)
    if name in ("lc", "he_explicit", "he_v2_mono", "ext_rate_escape"):
        assert isinstance(got, tuple), got
    elif name != "truncated":
        assert got == "CodecStreamCorrupt"


def _he_frames(bitstream, bitreader, sbr_mod, state_cls, core_fn):
    """dryrun_he.aac through a package's Python parser and its SbrDecoder:
    per frame (core PCM (2, 1024), the two channels' SBR data, their
    dequantised (E, Q))."""
    with open(chip_smoke.HE_ASSET, "rb") as f:
        data = f.read()
    dec, state, out, pos = None, state_cls(2), [], 0
    while (hdr := bitstream.parse_adts_header(data, pos)) is not None:
        fr = bitstream.parse_raw_data_block(
            bitreader(data, (pos + hdr.header_bytes) * 8), hdr.rate_index)
        pos += hdr.frame_bytes
        dec = dec or sbr_mod.SbrDecoder(hdr.sample_rate)
        core = core_fn([fr], state)
        chans, coupling = dec.parse_payload(*fr.sbr[:2], stereo=True,
                                            crc=fr.sbr[2])
        EQ = [dec.dequant(dec.header, c.grid, c.env, c.noise)
              for c in chans]
        if coupling:
            a = EQ[0][2]
            (EL, QL), (ER, QR) = dec.unmap_coupled(
                EQ[0][0], EQ[0][1], chans[1].env, chans[1].noise, a)
            EQ = [(EL, QL, a), (ER, QR, a)]
        out.append((core, chans, EQ))
    return dec, out


@pytest.mark.parametrize("method", ["decode_group", "decode_group_multi"])
def test_sbr_runner_pcm_methods_match_jax(method):
    """The runner's per-channel and PCM-mode methods on dryrun_he.aac's
    core PCM (the port's decode), in groups of 16 frames, within 2 LSB of
    the JAX runner's."""
    from ohpipeline_tpu.codecs.aac import bitstream as jbs
    from ohpipeline_tpu.codecs.aac import sbr as jsbr
    from ohpipeline_tpu.codecs.aac import sbr_jax
    from ohpipeline_tpu.codecs.aac import _StreamState as JaxState
    from ohpipeline_tpu.codecs.aac import decode_frames_float as jax_core
    from ohpipeline_tpu.codecs.flac.bitreader import BitReader as JaxReader
    from ohpipeline_tpu_torch.host.codecs.flac.bitreader import BitReader

    pdec, pframes = _he_frames(_host.aac_bitstream, BitReader, _host.aac_sbr,
                               aac_codec._StreamState,
                               aac_codec.decode_frames_float)
    jdec, jframes = _he_frames(jbs, JaxReader, jsbr, JaxState, jax_core)
    runners = (sbrd.SbrDeviceRunner(pdec, device="cpu"),
               sbr_jax.SbrDeviceRunner(jdec))
    outs = ([], [])
    for g in range(0, len(pframes), 16):
        core = np.stack([c for c, _, _ in pframes[g:g + 16]], axis=1)
        for runner, frames, out in zip(runners, (pframes, jframes), outs):
            chunk = frames[g:g + 16]
            per_ch = [([c[ch] for _, c, _ in chunk],
                       [eq[ch][0] for _, _, eq in chunk],
                       [eq[ch][1] for _, _, eq in chunk]) for ch in (0, 1)]
            if method == "decode_group":
                out.append(np.stack([runner.decode_group(ch, core[ch],
                                                         *per_ch[ch])
                                     for ch in (0, 1)]))
            else:
                out.append(runner.decode_group_multi(core, per_ch))
    port, jax = (np.concatenate(o, axis=1) for o in outs)
    assert port.shape == (2, 46 * 2048) and np.abs(port).max() > 1000
    assert np.abs(np.asarray(port, np.float64) - jax).max() <= 2


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("seed,channels", [(0, 2), (1, 1)])
def test_silk_packets_decode_as_jax(monkeypatch, path, seed, channels):
    """Seeded SILK-mode packets (TOC configs 0-11, mono and stereo) decode
    to the same PCM in the port and the JAX package, on the native parse
    and synthesis and with OHP_SILK_PY=1 (the Python parse)."""
    from ohpipeline_tpu.codecs.opus import decode_opus as jax_decode

    if path == "python":
        monkeypatch.setenv("OHP_SILK_PY", "1")
    data = chip_smoke.opus_ogg(chip_smoke.silk_packets(seed), channels)
    (pi, port), (ji, jax) = opus_codec.decode_opus(data), jax_decode(data)
    assert _info(pi) == _info(ji) and port.shape[0] == channels
    assert np.abs(port).max() > 100
    np.testing.assert_array_equal(port, jax)


def _alac_outcomes(pk: bytes, cfg, monkeypatch) -> list:
    """(outcome kind, PCM) of one packet through the port and the JAX
    package, each on its native core and on its Python loops."""
    from ohpipeline_tpu import native as jax_native
    from ohpipeline_tpu.codecs import alac as jax_alac

    out = []
    for mod, nat in ((AL, native), (jax_alac, jax_native)):
        for python in (False, True):
            if python:
                monkeypatch.setattr(nat, "have_alac_core", lambda: False)
            try:
                pcm, n = mod.decode_packet(pk, cfg)
                out.append(("ok", n, pcm))
            except Exception as exc:                    # noqa: BLE001
                out.append((type(exc).__name__, None, None))
            monkeypatch.undo()
    return out


@pytest.mark.parametrize("kind", ["random", "bitflip"])
def test_alac_hostile_packets_match_jax(monkeypatch, kind):
    """tests/test_native_fuzz_codecs.py's mutations (random bytes, single
    bit flips) on escape-frame packets: the port and the JAX package, native
    and Python, give the same PCM or the same exception type."""
    m4a, _pcm = chip_smoke.alac_escape_stream(1, 0.5)
    track = find_audio_track(m4a)
    cfg = AL.AlacConfig.parse(track.codec_config)
    packets = [m4a[o:o + s] for o, s in track.sample_offsets()]
    rng = np.random.default_rng(77 if kind == "random" else 78)
    kinds = set()
    for trial in range(60):
        if kind == "random":
            pk = rng.integers(0, 256, int(rng.integers(1, 160)),
                              dtype=np.uint8).tobytes()
        else:
            pk = bytearray(packets[int(rng.integers(0, len(packets)))])
            pk[int(rng.integers(0, len(pk)))] ^= 1 << int(rng.integers(0, 8))
            pk = bytes(pk)
        outs = _alac_outcomes(pk, cfg, monkeypatch)
        first = outs[0]
        kinds.add(first[0])
        for o in outs[1:]:
            assert o[:2] == first[:2], (trial, [x[0] for x in outs])
            if first[0] == "ok":
                np.testing.assert_array_equal(o[2], first[2])
    assert "ok" in kinds


# --- on the card ---------------------------------------------------------

@pytest.mark.gpu
def test_mp3_and_m4a_play_on_the_card_as_on_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for kind, lsb_max in (("cbr", 1), ("short_tail", 1), ("lc", 1),
                          ("he_explicit", 2)):
        path = tmp_path / kind
        path.write_bytes(_content(kind))
        _kernels.reset_launches()
        card, _, _ = watchdog(lambda: chip_smoke.render_play(str(path),
                                                             "cuda"))
        launched = dict(_kernels.launches)
        cpu, _, _ = watchdog(lambda: chip_smoke.render_play(str(path),
                                                            "cpu"))
        assert [_info(i) for i in card.infos] == [_info(i) for i in cpu.infos]
        assert _lsb(card.pcm, cpu.pcm) <= lsb_max, kind
        key = {"cbr": "mp3_window", "short_tail": "mp3_window",
               "he_explicit": "sbr_env"}.get(kind)
        if key:
            assert launched[key] > 0, (kind, launched)
        assert launched["tns"] == 0, (kind, launched)
