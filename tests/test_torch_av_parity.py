"""The port's MediaPlayer on the CPU, against the JAX package's MediaPlayer.

A playlist of a 2 s CD FLAC track, a 2 s MP3 (``chip_smoke.mp3_block_stream``:
long, start, short and stop blocks) and ``dryrun_he.aac`` cut at its 20th
frame (an SBR header) plays through the Playlist source of each player into
an AnimatorBatch, gaplessly, to the pipeline's halt.  At unity volume the
FLAC track equals its encoder input; at volume 50 (Volume.Limit 100) the
volume chain reaches the render chain's gain pass, and the port's FLAC track
equals the JAX one bit for bit (the port's RenderBatcher matches the JAX one
on XLA-CPU), its MP3 track within 1 LSB and its HE-AAC track within 2; the
pipeline announces the tracks in the database's order.  The Radio source's
``play_uri`` and ``play_preset``, a mute through the volume chain and
standby do what they do in the JAX package.  A kernel fault during a play
reaches the animator's caller.  The parts of the player that need the net
layer raise ``ModuleNotFoundError`` until it is ported.  Every animator run
goes through :func:`watchdog`, so a hang fails the test."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch import av as tav
from ohpipeline_tpu_torch.codecs import aac as aac_codec
from ohpipeline_tpu_torch.codecs.mp3 import synthesis as mp3_synthesis
from ohpipeline_tpu_torch.host.av import receiver_sources
from ohpipeline_tpu_torch.host.codecs.aac import bitstream as aac_bitstream
from ohpipeline_tpu_torch.ops import lpc as lpc_ops
from ohpipeline_tpu_torch.pipeline import AnimatorBatch
from test_torch_pipeline import watchdog

FLAC_SECONDS = 2.0
MP3_FRAMES = 77                      # 2.01 s at 44.1 kHz
HE_FRAMES = 20                       # frames 0-19: one SBR header period x 2
#: the port's output against the JAX player's at a non-unity gain, in LSB
LSB_MAX = {"FLAC": 0, "MP3": 1, "HE-AAC": 2}
NET = "ohpipeline_tpu_torch.host.net"


def he_cut(frames: int) -> bytes:
    """``dryrun_he.aac``'s first ``frames`` frames; frame ``frames`` carries
    an SBR header, so the cut ends where a header period ends."""
    data = open(chip_smoke.HE_ASSET, "rb").read()
    pos = 0
    for _ in range(frames):
        pos += aac_bitstream.parse_adts_header(data, pos).frame_bytes
    return data[:pos]


@pytest.fixture(scope="module")
def content(tmp_path_factory):
    """The playlist's files and the FLAC track's encoder input."""
    d = tmp_path_factory.mktemp("playlist")
    track = chip_smoke.make_track(FLAC_SECONDS, 44100, 7)
    files = {"flac": (_host.encode_flac(track, 44100, 16), "a.flac"),
             "mp3": (chip_smoke.mp3_block_stream(3, MP3_FRAMES), "b.mp3"),
             "he": (he_cut(HE_FRAMES), "c.aac")}
    paths = {}
    for name, (data, filename) in files.items():
        paths[name] = str(d / filename)
        with open(paths[name], "wb") as f:
            f.write(data)
    return paths, track


def port_run(start, volume=100, device="cpu", midway=None):
    return watchdog(lambda: chip_smoke.player_run(
        chip_smoke.media_player(device, volume), start, midway))


def jax_run(start, volume=100, midway=None):
    """The same run through the JAX package's MediaPlayer and its
    AnimatorBatch on XLA-CPU (use_device=True)."""
    from ohpipeline_tpu.av import MediaPlayer, MediaPlayerInitParams
    from ohpipeline_tpu.pipeline import AnimatorBatch, PipelineInitParams

    player = MediaPlayer(MediaPlayerInitParams(
        pipeline_params=chip_smoke.render_params(PipelineInitParams())))
    try:
        player.start()
        player.config.get("Volume.Limit").set(100)
        player.volumes.set_volume(volume)
    except BaseException:
        player.quit()
        raise
    return watchdog(lambda: chip_smoke.player_run(
        player, start, midway,
        animator=lambda up, sink: AnimatorBatch(up, sink, use_device=True)))


def lsb(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


@pytest.mark.parametrize("volume", [100, 50])
def test_a_playlist_matches_the_jax_media_player(content, volume):
    paths, track = content
    start = chip_smoke.playlist([paths["flac"], paths["mp3"], paths["he"]])
    sink, _, batcher, track_ids, ids, _ = port_run(start, volume)
    jsink, _, _, jtrack_ids, jids, _ = jax_run(start, volume)
    assert track_ids == ids == jtrack_ids == jids == [1, 2, 3]
    got, want = chip_smoke.stream_pcm(sink), chip_smoke.stream_pcm(jsink)
    assert [i.codec_name for i, _ in got] == ["FLAC", "MP3", "HE-AAC"]
    assert [i.codec_name for i, _ in want] == ["FLAC", "MP3", "HE-AAC"]
    assert got[1][1].shape[1] == MP3_FRAMES * 1152
    assert got[2][1].shape[1] == HE_FRAMES * 2048
    for (info, pcm), (_, jpcm) in zip(got, want):
        assert lsb(pcm, jpcm) <= LSB_MAX[info.codec_name], info.codec_name
    if volume == 100:
        np.testing.assert_array_equal(got[0][1], track)
        assert batcher.gain_tiles == 0
    else:
        assert batcher.gain_tiles > 0
        flac = got[0][1]
        assert np.abs(flac).max() < np.abs(track).max() // 2


def radio_preset(path: str):
    """A start: the Radio source stores ``path`` as preset 3 and plays it."""

    def start(player) -> None:
        player.product.set_source_by_name("Radio")
        player.source_radio.presets.set_preset(3, f"file://{path}")
        player.source_radio.play_preset(3)

    return start


@pytest.mark.parametrize("play", [chip_smoke.radio_uri, radio_preset],
                         ids=["play_uri", "play_preset"])
def test_the_radio_source_matches_the_jax_media_player(content, play):
    paths, track = content
    start = play(paths["flac"])
    sink, _, _, track_ids, _, _ = port_run(start)
    np.testing.assert_array_equal(sink.pcm, track)
    sink, _, batcher, _, _, _ = port_run(start, 50)
    jsink, _, _, jtrack_ids, _, _ = jax_run(start, 50)
    assert batcher.gain_tiles > 0
    np.testing.assert_array_equal(sink.pcm, jsink.pcm)
    assert track_ids == jtrack_ids and len(track_ids) == 1


def test_a_mute_zeroes_the_output_from_the_mute_on(content):
    paths, track = content
    start = chip_smoke.playlist([paths["flac"], paths["mp3"]])
    mute = (3, lambda player: player.volumes.mute())
    sink, _, batcher, _, _, at = port_run(start, midway=mute)
    jsink, _, _, _, _, jat = jax_run(start, midway=mute)
    assert 0 < at < track.shape[1] and at == jat
    np.testing.assert_array_equal(sink.pcm[:, :at], track[:, :at])
    assert sink.samples > at and not sink.pcm[:, at:].any()
    assert batcher.gain_tiles > 0
    np.testing.assert_array_equal(sink.pcm, jsink.pcm)


def test_standby_matches_the_jax_media_player(content):
    """Standby mid-play: the product and the power manager enter standby.
    In the JAX package neither the Playlist source nor the volume chain
    stops the pipeline on it, so the play runs on to its end there, and in
    the port."""
    paths, track = content
    states = []

    def standby(player):
        player.product.standby_enable()
        player.power.standby_enable()
        states.append((player.product.standby, player.power.standby,
                       player.volumes.volume, player.volumes.muted))

    start = chip_smoke.playlist([paths["flac"]])
    sink, _, _, _, _, at = port_run(start, midway=(3, standby))
    jsink, _, _, _, _, jat = jax_run(start, midway=(3, standby))
    assert states == [(True, True, 100, False)] * 2
    assert 0 < at == jat < track.shape[1]
    np.testing.assert_array_equal(sink.pcm, jsink.pcm)
    np.testing.assert_array_equal(sink.pcm, track)


def _raise_kernel_error(*args, **kwargs):
    raise _kernels.KernelError("kernel launch failed: CUDA error 719")


@pytest.mark.parametrize("where", ["flac", "mp3", "he"])
def test_a_kernel_fault_during_a_play_reaches_the_animators_caller(
        content, monkeypatch, where):
    """The fault hits the playlist's first, second or third track at volume
    50: the tracks before it play, the animator's caller gets the error,
    and nothing of the faulted track or after it is played."""
    paths, track = content
    target = {"flac": (lpc_ops, "lpc_synthesize"),
              "mp3": (mp3_synthesis, "mp3_window"),
              "he": (aac_codec, "_sbr_decode_frames_lazy")}[where]
    monkeypatch.setattr(*target, _raise_kernel_error)
    player = chip_smoke.media_player("cpu", 50)
    kinds = []
    start = chip_smoke.playlist([paths["flac"], paths["mp3"], paths["he"]])
    sink = chip_smoke.Sink()
    pull = player.pipeline.pipeline.predriver.pull

    def recording_pull():
        e = pull()
        kinds.append(e.kind)
        return e

    player.pipeline.pipeline.predriver.pull = recording_pull
    try:
        animator = AnimatorBatch(player.pipeline.pipeline.predriver, sink,
                                 device=player.device)
        start(player)
        with pytest.raises(_kernels.KernelError, match="CUDA error 719"):
            watchdog(animator.run)
        assert isinstance(player.pipeline.pipeline.fault, _kernels.KernelError)
    finally:
        player.quit()
    assert "stream_interrupted" not in kinds
    played = [i.codec_name for i, _ in chip_smoke.stream_pcm(sink)]
    assert played == ["FLAC", "MP3", "HE-AAC"][:["flac", "mp3",
                                                 "he"].index(where)]


@pytest.mark.parametrize("call", [
    "add_songcast_sender", "start_upnp", "start_openhome_upnp",
    "start_with_shell"])
def test_the_players_net_parts_wait_for_the_net_layer(call):
    params = tav.MediaPlayerInitParams(
        shell_port=0 if call == "start_with_shell" else None)
    player = tav.MediaPlayer(params, device="cpu")
    try:
        with pytest.raises(ModuleNotFoundError) as info:
            if call == "start_with_shell":
                player.start()
            else:
                getattr(player, call)()
        assert info.value.name.startswith(NET), info.value
    finally:
        player.quit()


@pytest.mark.parametrize("use", [
    lambda mgr: receiver_sources.SourceReceiver(mgr).activate(),
    lambda mgr: receiver_sources.SourceReceiver(mgr).set_sender(),
    lambda mgr: receiver_sources.SourceScd(mgr).connect("127.0.0.1", 9),
    lambda mgr: receiver_sources.SourceRaop(mgr).start_endpoint()],
    ids=["receiver_activate", "receiver_set_sender", "scd_connect",
         "raop_endpoint"])
def test_the_receiver_sources_wait_for_the_net_layer(use):
    player = tav.MediaPlayer(device="cpu")
    try:
        with pytest.raises(ModuleNotFoundError) as info:
            use(player.pipeline)
        assert info.value.name.startswith(NET), info.value
    finally:
        player.quit()


def test_the_av_facade_exports_the_jax_names():
    from ohpipeline_tpu import av as jav

    assert sorted(tav.__all__) == sorted(jav.__all__)
    for name in tav.__all__:
        assert getattr(tav, name).__name__ == getattr(jav, name).__name__


def test_without_cryptography_the_player_raises_naming_it():
    """The credential store encrypts with RSA (the ``cryptography``
    package); without the package a player cannot be built, and says why.
    The other Av modules import without it."""
    code = "\n".join([
        "import sys",
        "sys.modules['cryptography'] = None",
        "sys.modules['jax'] = sys.modules['ohpipeline_tpu'] = None",
        "import importlib",
        "for m in ('config', 'power', 'product', 'misc', 'ops_support',",
        "          'volume', 'sources', 'oauth', 'pins', 'podcasts',",
        "          'reactions', 'sender', 'raat', 'receiver_sources'):",
        "    importlib.import_module('ohpipeline_tpu_torch.host.av.' + m)",
        "from ohpipeline_tpu_torch.av import MediaPlayer",
        "try:",
        "    MediaPlayer(device='cpu')",
        "except ImportError as e:",
        "    assert 'cryptography' in str(e), e",
        "    print('needs cryptography')",
    ])
    env = dict(os.environ, PYTHONPATH=chip_smoke.HERE)
    proc = subprocess.run([sys.executable, "-c", code], cwd=chip_smoke.HERE,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "needs cryptography" in proc.stdout


@pytest.mark.gpu
def test_a_playlist_on_the_card_matches_the_cpu(content):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    paths, track = content
    start = chip_smoke.playlist([paths["flac"], paths["mp3"], paths["he"]])
    _kernels.reset_launches()
    card, _, batcher, track_ids, ids, _ = port_run(start, 50, "cuda")
    launches = dict(_kernels.launches)
    cpu, _, _, _, _, _ = port_run(start, 50, "cpu")
    assert track_ids == ids
    assert batcher.device.type == "cuda" and batcher.gain_tiles > 0
    assert launches["lpc"] > 0 and launches["mp3_window"] > 0 \
        and launches["sbr_env"] > 0
    for (info, a), (_, b) in zip(chip_smoke.stream_pcm(card),
                                 chip_smoke.stream_pcm(cpu)):
        assert lsb(a, b) <= LSB_MAX[info.codec_name], info.codec_name
    unity, _, _, _, _, _ = port_run(start, 100, "cuda")
    np.testing.assert_array_equal(chip_smoke.stream_pcm(unity)[0][1], track)
