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
reaches the animator's caller.  The parts of the player and of its receiver
sources that reach the net layer do what the JAX package's do.  Every animator run
goes through :func:`watchdog`, so a hang fails the test."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch import av as tav
from ohpipeline_tpu_torch.codecs import aac as aac_codec
from ohpipeline_tpu_torch.codecs.mp3 import synthesis as mp3_synthesis
from ohpipeline_tpu_torch.host.codecs.aac import bitstream as aac_bitstream
from ohpipeline_tpu_torch.ops import lpc as lpc_ops
from ohpipeline_tpu_torch.pipeline import AnimatorBatch
from test_torch_pipeline import watchdog

FLAC_SECONDS = 2.0
MP3_FRAMES = 77                      # 2.01 s at 44.1 kHz
HE_FRAMES = 20                       # frames 0-19: one SBR header period x 2
#: the port's output against the JAX player's at a non-unity gain, in LSB
LSB_MAX = {"FLAC": 0, "MP3": 1, "HE-AAC": 2}


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


def upnp_services(device) -> dict:
    """A published UPnP device's services: {path: (type, id, actions)}."""
    try:
        return {path: (svc.service_type, svc.service_id, sorted(svc.actions))
                for path, svc in device.services.items()}
    finally:
        device.close()


def shell_info(player) -> str:
    """start() with a shell port, and the shell's answer to ``info``."""
    player.start()
    with socket.create_connection(("127.0.0.1", player.shell.port),
                                  timeout=10) as conn:
        f = conn.makefile("rwb")
        assert f.read(2 + len(b"ohpipeline shell\n")).endswith(b"> ")
        f.write(b"info\n")
        f.flush()
        return f.readline().decode()


#: The player's parts that need the net layer: what each gives.
NET_PARTS = {
    "add_songcast_sender": lambda p: (      # the channel is random else
        type(p.add_songcast_sender(default_channel=7)).__name__,
        {k: p.config.get(k).value for k in p.config.keys()
         if k.startswith("Sender.")}),
    "start_upnp": lambda p: upnp_services(p.start_upnp(ssdp=False)),
    "start_openhome_upnp": lambda p: upnp_services(
        p.start_openhome_upnp(ssdp=False)),
    "start_with_shell": shell_info,
}


@pytest.mark.parametrize("call", [
    "add_songcast_sender", "start_upnp", "start_openhome_upnp",
    "start_with_shell"])
def test_the_players_net_parts_wait_for_the_net_layer(call):
    """The parts of the player that reach the net layer (they raised
    ModuleNotFoundError until it was ported) give what the JAX player's
    give: the Songcast sender and its Sender.* config values, the services
    of the published UPnP devices (ports and UDNs aside) and the debug
    shell's answer to ``info`` over TCP."""
    from ohpipeline_tpu import av as jav

    shell = 0 if call == "start_with_shell" else None
    got = []
    for av, kw in ((tav, {"device": "cpu"}), (jav, {})):
        player = av.MediaPlayer(av.MediaPlayerInitParams(shell_port=shell),
                                **kw)
        try:
            got.append(NET_PARTS[call](player))
        finally:
            player.quit()
    assert got[0] and got[0] == got[1], got


def wait_for(cond, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def receiver_joins(pkg, mgr, retarget: bool) -> tuple:
    """A SourceReceiver (unicast) activated against a live OhmSender on
    127.0.0.1 joins it; with ``retarget``, set_sender then points it at
    that sender.  Returns what the source and the sender show."""
    ohm = pkg["songcast"].OhmSender(multicast=False)
    ohm.start()
    endpoint = ("127.0.0.1", ohm.endpoint[1])
    src = pkg["receiver_sources"].SourceReceiver(
        mgr, multicast=False, sender_endpoint=endpoint)
    try:
        src.activate()
        joined = wait_for(lambda: len(ohm._listeners) == 1)
        out = (src.active, src.playing, joined)
        if retarget:
            src.set_sender(f"ohm://127.0.0.1:{endpoint[1]}", "<m/>")
            out += (src.sender_info()[1], src.uri == src.sender_info()[0],
                    src.provider._track.uri == src.uri)
        return out
    finally:
        src.deactivate()
        ohm.stop()


def scd_connects(pkg, mgr) -> tuple:
    """SourceScd.connect to a live ScdSender on 127.0.0.1."""
    sender = pkg["scd"].ScdSender()
    src = pkg["receiver_sources"].SourceScd(mgr)
    try:
        src.connect("127.0.0.1", sender.port)
        return (wait_for(lambda: len(sender._clients) == 1),
                src.provider._track.uri == f"scd://127.0.0.1:{sender.port}")
    finally:
        src.deactivate()
        sender.close()


def raop_listens(pkg, mgr) -> tuple:
    """SourceRaop.start_endpoint binds an RTSP listener that takes a TCP
    connection on 127.0.0.1."""
    src = pkg["receiver_sources"].SourceRaop(mgr)
    try:
        port = src.start_endpoint()
        with socket.create_connection(("127.0.0.1", port), timeout=5):
            pass
        return (port > 0, port == src.receiver.rtsp_port)
    finally:
        src.deactivate()


RECEIVER_USES = {
    "receiver_activate": lambda pkg, mgr: receiver_joins(pkg, mgr, False),
    "receiver_set_sender": lambda pkg, mgr: receiver_joins(pkg, mgr, True),
    "scd_connect": scd_connects,
    "raop_endpoint": raop_listens,
}


@pytest.mark.parametrize("use", list(RECEIVER_USES))
def test_the_receiver_sources_wait_for_the_net_layer(use):
    """The receiver sources' uses of the net layer (they raised
    ModuleNotFoundError until it was ported) work on loopback as the JAX
    package's do."""
    import importlib

    from ohpipeline_tpu import av as jav

    got = []
    for av, root, kw in ((tav, "ohpipeline_tpu_torch.host", {"device": "cpu"}),
                         (jav, "ohpipeline_tpu", {})):
        pkg = {name: importlib.import_module(f"{root}.{where}.{name}")
               for where, name in (("av", "receiver_sources"),
                                   ("net", "songcast"), ("net", "scd"))}
        player = av.MediaPlayer(**kw)
        try:
            got.append(RECEIVER_USES[use](pkg, player.pipeline))
        finally:
            player.quit()
    assert all(got[0]) and got[0] == got[1], got


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
