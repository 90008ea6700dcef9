"""The port's ADTS codec plug-in (ohpipeline_tpu_torch.codecs.aac.CodecAacAdts)
against the JAX package's, on tests/assets/dryrun.aac (AAC-LC: short
windows, TNS, PNS, M/S) and dryrun_he.aac (HE-AAC v1), with the native
unpacker and with the Python parser; the stream description, recognition
and ``decode_adts``; the HE groups' routing between the device runners and
sbr.py's per-frame numpy chain (a group with a missing SBR payload), for v1
and, through the plug-in's group helpers, for v2 (parametric stereo) on
``chip_smoke.ps_content``'s channel data: the repository has no v2 stream.

Tolerances, and why: <= 1 LSB on AAC-LC (the same float32 filterbank, its
products summed in another order), <= 2 LSB on HE-AAC (the SBR group's own
bound: the transposer's covariances cancel on tonal bands, see
test_torch_aac_sbr.py); <= 4 LSB on the v2 groups, whose core here is the
asset's left channel at full level (ps_content runs it at half level) and
whose mixing matrices carry the SBR group's error with gains up to
|h11| + |h21| <= 2 sqrt(2) (3 LSB measured)."""

import dataclasses
import pathlib

import numpy as np
import pytest

import chip_smoke
from ohpipeline_tpu_torch._host import aac_bitstream as BS
from ohpipeline_tpu_torch._host import aac_sbr as SBR
from ohpipeline_tpu_torch._host import base
from ohpipeline_tpu_torch.codecs import aac
from ohpipeline_tpu_torch.host.codecs.flac.bitreader import BitReader

ASSETS = pathlib.Path(__file__).resolve().parent / "assets"
LSB = {"dryrun.aac": 1, "dryrun_he.aac": 2}


def _decode(codec, data: bytes, reader_cls, end) -> tuple:
    r = reader_cls(data)
    info = codec.stream_initialise(r)
    parts, offsets = [], []
    while True:
        try:
            b = codec.process(r)
        except end:
            break
        offsets.append(b.track_offset_samples)
        parts.append(b.resolve())
    return info, np.concatenate(parts, axis=1), offsets


def _fields(info) -> dict:
    """A PcmStreamInfo's fields, enums by value (each package has its own
    enum classes)."""
    return {k: getattr(v, "value", v)
            for k, v in dataclasses.asdict(info).items()}


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
               .max())


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("asset", sorted(LSB))
def test_codec_matches_jax(asset, use_native):
    from ohpipeline_tpu.codecs import aac as jaac
    from ohpipeline_tpu.codecs import base as jbase

    data = (ASSETS / asset).read_bytes()
    port = aac.CodecAacAdts(use_native=use_native, device="cpu")
    info, got, offs = _decode(port, data, base.BufferReader,
                              base.EndOfStream)
    jinfo, want, joffs = _decode(jaac.CodecAacAdts(use_native=use_native),
                                 data, jbase.BufferReader, jbase.EndOfStream)
    assert _fields(info) == _fields(jinfo)
    assert got.shape == want.shape and got.dtype == np.int32
    assert offs == joffs
    assert _lsb(got, want) <= LSB[asset]
    if asset == "dryrun_he.aac":
        assert info.codec_name == "HE-AAC" and info.sample_rate == 44100
        assert port._sbr._device_runner is not None
        assert port._sbr._device_runner.device.type == "cpu"
    else:
        assert info.codec_name == "AAC" and port._sbr is None


def test_recognise():
    from ohpipeline_tpu.codecs import aac as jaac

    c, j = aac.CodecAacAdts(device="cpu"), jaac.CodecAacAdts()
    for asset in sorted(LSB):
        head = (ASSETS / asset).read_bytes()[:8192]
        assert c.recognise(head) and j.recognise(head)
    flac = b"fLaC" + bytes(8188)
    one = (ASSETS / "dryrun.aac").read_bytes()
    h = BS.parse_adts_header(one)
    lone = one[:h.frame_bytes] + bytes(64)      # one header, no second
    for head in (flac, lone, bytes(16)):
        assert not c.recognise(head) and not j.recognise(head)


def test_decode_adts_matches_jax():
    from ohpipeline_tpu.codecs import aac as jaac

    data = (ASSETS / "dryrun.aac").read_bytes()
    info, got = aac.decode_adts(data, device="cpu")
    jinfo, want = jaac.decode_adts(data)
    assert _fields(info) == _fields(jinfo)
    assert got.shape == want.shape == (2, 89 * 1024)
    assert _lsb(got, want) <= 1


def _python_frames(data: bytes, n: int) -> list:
    frames, pos = [], 0
    while len(frames) < n:
        h = BS.parse_adts_header(data, pos)
        frames.append(BS.parse_raw_data_block(
            BitReader(data, (pos + h.header_bytes) * 8), h.rate_index))
        pos += h.frame_bytes
    return frames


def test_sbr_groups_switch_paths_like_jax():
    """Three HE groups: on the device, through the numpy chain (a frame
    without its SBR payload: the device runner hands its core overlap
    back), on the device again (a runner seeded from the host)."""
    from ohpipeline_tpu.codecs import aac as jaac
    from ohpipeline_tpu.codecs.aac import sbr as jsbr

    data = (ASSETS / "dryrun_he.aac").read_bytes()
    frames = _python_frames(data, 36)
    frames[17].sbr = None
    rate = BS.parse_adts_header(data).sample_rate
    dec, jdec = SBR.SbrDecoder(rate), jsbr.SbrDecoder(rate)
    st, jst = aac._StreamState(2), jaac._StreamState(2)
    for g in range(3):
        chunk = frames[12 * g:12 * (g + 1)]
        got = aac._sbr_decode_frames(chunk, st, dec, 2, device="cpu")
        want = jaac._sbr_decode_frames(chunk, jst, jdec, 2)
        assert got.shape == want.shape == (2, 12 * 2048)
        assert _lsb(got, want) <= 2
        assert np.abs(np.asarray(st.overlap) - jst.overlap).max() \
            <= 1e-4 * np.abs(jst.overlap).max()
        # the device runner holds the core overlap after a device group
        assert dec._device_runner._host_ov == (g == 1)


def _ps_decoder(cls, content: dict):
    """A ``cls`` SbrDecoder whose payloads are ps_content's frame indices:
    parse_payload hands back that frame's channel data (its SBR data and
    PsData), as a mono v2 stream's parse would."""
    class PsContent(cls):
        def parse_payload(self, payload, nbits, stereo, crc):
            assert not stereo
            return [content["datas"][payload]], False

    dec = PsContent(content["dec"].core_rate)
    dec.set_header(content["dec"].header)
    return dec


def test_ps_groups_through_the_plugin_helpers_match_jax():
    """v2 groups through the plug-in's helpers (_sbr_decode_frames with
    ps): on the device (SbrPsDeviceRunner, spec mode), through the numpy
    chain (a frame without its payload), on the device again; the core is
    dryrun_he.aac's left channel (the mid of its M/S frames) as a mono
    stream, the SBR and PS data ps_content's."""
    from ohpipeline_tpu.codecs import aac as jaac
    from ohpipeline_tpu.codecs.aac import sbr as jsbr

    F = 24
    content = chip_smoke.ps_content(0, F)
    frames = []           # mono frames: the left channel (M/S mid) alone
    for f, fr in enumerate(_python_frames(
            (ASSETS / "dryrun_he.aac").read_bytes(), F)):
        frames.append(BS.FrameData([fr.channels[0]], None, fr.rate_index))
        frames[-1].sbr = (f, 0, False) if f != 11 else None
    dec = _ps_decoder(SBR.SbrDecoder, content)
    jdec = _ps_decoder(jsbr.SbrDecoder, content)
    st, jst = aac._StreamState(1), jaac._StreamState(1)
    for g in range(3):
        chunk = frames[8 * g:8 * (g + 1)]
        got = aac._sbr_decode_frames(chunk, st, dec, 1, ps=True,
                                     device="cpu")
        want = jaac._sbr_decode_frames(chunk, jst, jdec, 1, ps=True)
        assert got.shape == want.shape == (2, 8 * 2048)
        assert _lsb(got, want) <= 4 and np.abs(got).max() > 1000
        assert dec._ps_device_runner._core_ov is None if g == 1 \
            else dec._ps_device_runner._core_ov is not None
