"""Every public entry point of the port runs on the card unless the caller
asks for the CPU: ``device`` defaults to "cuda", and without a card a call
that names no device raises; it does not run on the CPU.  The same holds
for the mesh: ``make_mesh()`` spans the visible cards, so with none (and no
named devices) it raises, as do the calls built on it, and a mesh of more
cards than there are raises."""

import inspect
import pathlib

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import (_host, _kernels, av, bench, bench_secondary,
                                  parallel, pipeline)
from ohpipeline_tpu_torch.codecs import aac
from ohpipeline_tpu_torch.codecs.aac import sbr as aac_sbr
from ohpipeline_tpu_torch.codecs.aac import serving as aac_serving
from ohpipeline_tpu_torch.codecs.flac import serving as flac_serving
from ohpipeline_tpu_torch.codecs.mp3 import serving as mp3_serving
from ohpipeline_tpu_torch.codecs.opus import celt
from ohpipeline_tpu_torch.codecs.vorbis import device as vorbis_device
from ohpipeline_tpu_torch.entry import dryrun_multichip, entry
from ohpipeline_tpu_torch.tools import player

ASSETS = pathlib.Path(__file__).resolve().parent / "assets"


def _flac():
    x = np.stack([np.arange(3000) % 200 - 100] * 2).astype(np.int32)
    return _host.encode_flac(x, 44100, 16, blocksize=1024)


def _mp3():
    tone = _host.mp3_encoder.tone_spectrum(30)
    return _host.mp3_encoder.build_stream([tone, tone], nframes=3)


def _vorbis():
    spec = _host.vorbis_encoder.StreamSpec(channels=1, sample_rate=44100,
                                           bs0=256, bs1=1024,
                                           coupling=False)
    res = np.zeros((1, 512), np.int64)
    res[0, 10] = 2
    return spec.build([(1, [(140, 120)], res)] * 3)


CALLS = {
    "entry": (entry, lambda: ()),
    "decode_flac_streams_device": (
        flac_serving.decode_flac_streams_device, lambda: ([_flac()], 8)),
    "decode_aac_streams_device": (
        aac_serving.decode_aac_streams_device,
        lambda: ([(ASSETS / "dryrun.aac").read_bytes()],)),
    "decode_adts": (
        aac.decode_adts, lambda: ((ASSETS / "dryrun_he.aac").read_bytes(),)),
    "decode_he_streams_device": (
        aac_serving.decode_he_streams_device,
        lambda: ([(ASSETS / "dryrun_he.aac").read_bytes()],)),
    "decode_celt_streams_device": (
        celt.decode_celt_streams_device,
        lambda: ([(ASSETS / "dryrun.opus").read_bytes()],)),
    "decode_celt_stream_device": (
        celt.decode_celt_stream_device,
        lambda: ((ASSETS / "dryrun.opus").read_bytes(),)),
    "decode_mp3_streams_device": (
        mp3_serving.decode_mp3_streams_device, lambda: ([_mp3()],)),
    "decode_vorbis_streams_device": (
        vorbis_device.decode_vorbis_streams_device, lambda: ([_vorbis()],)),
    "decode_vorbis_stream_device": (
        vorbis_device.decode_vorbis_stream_device, lambda: (_vorbis(),)),
    "bench.run": (bench.run, lambda: (1, 1, 0.5, 1)),
    "bench_secondary.floor_probe": (bench_secondary.floor_probe,
                                    lambda: (1,)),
    "bench_secondary.all_codecs_bench": (bench_secondary.all_codecs_bench,
                                         lambda: (1,)),
    "bench_secondary.main": (bench_secondary.main, lambda: ()),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_device_defaults_to_the_card(name):
    fn, _ = CALLS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(CALLS))
def test_without_a_card_a_call_naming_no_device_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fn, args = CALLS[name]
    with pytest.raises((AssertionError, RuntimeError)):
        fn(*args())


def _codec_group():
    codec = aac.CodecAacAdts()
    reader = _host.base.BufferReader((ASSETS / "dryrun.aac").read_bytes())
    codec.stream_initialise(reader)
    codec.process(reader).resolve()


def _sbr_decoder():
    _host.sbr_native()
    data = (ASSETS / "dryrun_he.aac").read_bytes()
    dec = _host.aac_sbr.SbrDecoder(
        _host.aac_bitstream.parse_adts_header(data).sample_rate)
    _, _, b = _host.aac_native().aac_parse_group_sbr(data, 0, channels=2,
                                                    max_frames=1)
    payload, nbits, crc = b["sbr"][0]
    dec.parse_payload(payload, nbits, stereo=True, crc=crc)
    return dec


#: Classes whose work runs on ``device``: (class, one use that names no
#: device).
CLASSES = {
    "CodecAacAdts": (aac.CodecAacAdts, _codec_group),
    "SbrDeviceRunner": (aac_sbr.SbrDeviceRunner,
                        lambda: aac_sbr.SbrDeviceRunner(_sbr_decoder())),
    "SbrPsDeviceRunner": (aac_sbr.SbrPsDeviceRunner,
                          lambda: aac_sbr.SbrPsDeviceRunner(_sbr_decoder())),
    "MediaPlayer": (av.MediaPlayer, lambda: av.MediaPlayer()),
    "AnimatorSongcastSender": (
        pipeline.AnimatorSongcastSender,
        lambda: pipeline.AnimatorSongcastSender(None, None)),
}


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_classes_default_to_the_card(name):
    cls, _ = CLASSES[name]
    assert inspect.signature(cls).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_without_a_card_a_class_naming_no_device_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, use = CLASSES[name]
    with pytest.raises((AssertionError, RuntimeError)):
        use()


def test_without_a_card_the_player_naming_no_device_raises(tmp_path):
    """The player entry point takes ``--device`` (default "cuda"); without
    a card and without ``--cpu`` it raises before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "o.wav"
    with pytest.raises(_kernels.KernelError):
        player.main(["--uri", "tone://sine.wav?duration=1", "--wav",
                     str(out)])
    assert not out.exists()


def test_without_a_card_the_bench_naming_no_device_raises(capsys):
    """The bench runs on the card unless ``--cpu`` is given: without a card
    it raises before it builds content or prints a line, whichever bench
    is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["--smoke"], [], ["--secondary"], ["--all-codecs"]):
        with pytest.raises(_kernels.KernelError):
            bench.main(argv)
    assert capsys.readouterr().out == ""


#: Mesh calls that name no device: they span the visible cards.
MESH_CALLS = {
    "make_mesh": lambda: parallel.make_mesh(),
    "dryrun_multichip": lambda: dryrun_multichip(),
    "sharded_pipeline_step": lambda: parallel.sharded_pipeline_step(
        parallel.make_mesh()),
}


@pytest.mark.parametrize("name", sorted(MESH_CALLS))
def test_without_a_card_a_mesh_naming_no_device_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MESH_CALLS[name]()


def test_a_mesh_of_more_cards_than_there_are_raises():
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError):
        parallel.make_mesh(n + 1)
    with pytest.raises(RuntimeError):
        parallel.make_mesh(devices=[f"cuda:{n}"])
