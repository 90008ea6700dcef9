"""Songcast through the port's MediaPlayers on the CPU, against the JAX
package's.

Sender: a 2 s CD FLAC track and a 2 s MP3 play through each package's
MediaPlayer Playlist source at volume 50 (Volume.Limit 100) into its
AnimatorSongcastSender and an OHM sender that keeps what it is sent
(``chip_smoke.OhmRecorder``).  The senders run at their 5 ms cadence: a
free-running one sends a silence frame whenever its pipeline has no event
ready, and that loop holds the interpreter from the decoding threads for
minutes on this content.  The port's sent audio, its silence
frames dropped, equals the JAX package's: the FLAC track bit for bit, the
MP3 track within 1 LSB; each frame starts where the one before it ended.

Receiver: the port's sent audio frames, then a halt, go into each package's
SourceReceiver as its OhmReceiver would hand them on, at volume 50, and an
AnimatorBatch renders to the pipeline's halt: the port's output equals the
JAX package's bit for bit.

Loopback: a sender MediaPlayer of the port plays a 1 s FLAC track into a
real unicast OhmSender on 127.0.0.1, paced at its audio clock, and a
receiver MediaPlayer of the port, its SourceReceiver joined to it, renders
in real time (``chip_smoke.songcast_loopback``): every frame delivered is
the frame sent, bit for bit, and the receiver's output holds the sent audio
at its gain (``chip_smoke.loopback_gates``).  On the card the same loopback
with both players on ``cuda`` sends what the CPU's sends."""

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host
from ohpipeline_tpu_torch.host.net.songcast import OhmAudio
from test_torch_pipeline import watchdog

SECONDS = 2.0
#: the port's sent or rendered audio against the JAX package's, in LSB
MP3_LSB = 1


@pytest.fixture(scope="module")
def content(tmp_path_factory):
    """The FLAC and MP3 files, the FLAC track's encoder input and a 1 s
    FLAC file for the loopback."""
    d = tmp_path_factory.mktemp("songcast")
    track = chip_smoke.make_track(SECONDS, 44100, 7)
    short = chip_smoke.make_track(1.0, 44100, 8)
    files = {"flac": _host.encode_flac(track, 44100, 16),
             "mp3": chip_smoke.mp3_bench_stream(0, SECONDS),
             "short": _host.encode_flac(short, 44100, 16)}
    paths = {}
    for name, data in files.items():
        paths[name] = str(d / f"{name}.{'mp3' if name == 'mp3' else 'flac'}")
        with open(paths[name], "wb") as f:
            f.write(data)
    return paths, track, short


def jax_player(volume, setup=None):
    """The JAX package's MediaPlayer as chip_smoke.media_player makes the
    port's."""
    from ohpipeline_tpu.av import MediaPlayer, MediaPlayerInitParams
    from ohpipeline_tpu.pipeline import PipelineInitParams

    player = MediaPlayer(MediaPlayerInitParams(
        pipeline_params=chip_smoke.render_params(PipelineInitParams())))
    try:
        if setup is not None:
            setup(player)
        player.start()
        player.config.get("Volume.Limit").set(100)
        player.volumes.set_volume(volume)
    except BaseException:
        player.quit()
        raise
    return player


def jax_sender(upstream, ohm):
    from ohpipeline_tpu.pipeline.animator import AnimatorSongcastSender

    return AnimatorSongcastSender(upstream, ohm, use_device=True)


@pytest.fixture(scope="module")
def sent(content):
    """Each package's OhmRecorder after the playlist at volume 50."""
    paths, _, _ = content
    start = chip_smoke.playlist([paths["flac"], paths["mp3"]])
    port, jax = chip_smoke.OhmRecorder(), chip_smoke.OhmRecorder()
    watchdog(lambda: chip_smoke.songcast_send(
        chip_smoke.media_player("cpu", 50), start, port, realtime=True))
    watchdog(lambda: chip_smoke.songcast_send(
        jax_player(50), start, jax, realtime=True, animator=jax_sender))
    return port, jax


def test_the_sent_audio_matches_the_jax_sender(content, sent):
    _, track, _ = content
    port, jax = sent
    got, want = port.audio(), jax.audio()
    n = track.shape[1]
    assert got.shape == want.shape and got.shape[1] > n
    np.testing.assert_array_equal(got[:, :n], want[:, :n])
    assert int(np.abs(got[:, n:].astype(np.int64) - want[:, n:]).max()) \
        <= MP3_LSB
    # volume 50 reached the gain pass: the FLAC track is far below its input
    assert 0 < np.abs(got[:, :n]).max() < np.abs(track).max() // 8
    assert port.positions_run_on() and jax.positions_run_on()
    assert port.halt_after_audio and jax.halt_after_audio


def jax_receiver(volume):
    from ohpipeline_tpu.av.receiver_sources import SourceReceiver

    sources = []

    def add(player):
        sources.append(SourceReceiver(player.pipeline, multicast=False))
        player.add_source(sources[0])

    return jax_player(volume, add), sources[0]


def test_the_receiver_renders_pushed_frames_as_the_jax_receiver(content):
    """The frames are the FLAC track's in 1024-sample frames, as a sender
    at unity gain sends them (the loopback test holds it to that): at
    volume 50 (-50 dB) the sender's own frames would render as silence."""
    from ohpipeline_tpu.net.songcast import OhmAudio as JaxOhmAudio
    from ohpipeline_tpu.pipeline import AnimatorBatch as JaxAnimatorBatch

    _, track, _ = content
    frames = [(i, track[:, i:i + 1024])
              for i in range(0, track.shape[1], 1024)]
    got = watchdog(lambda: chip_smoke.receiver_push(
        *chip_smoke.receiver_player("cpu", 50), frames, OhmAudio))
    want = watchdog(lambda: chip_smoke.receiver_push(
        *jax_receiver(50), frames, JaxOhmAudio,
        animator=lambda up, sink: JaxAnimatorBatch(up, sink,
                                                   use_device=True)))
    assert got.pcm.shape == want.pcm.shape
    np.testing.assert_array_equal(got.pcm, want.pcm)
    # every pushed sample was rendered, at the receiver's gain
    assert np.count_nonzero(got.pcm.any(axis=0)) >= 0.9 * track.shape[1]
    assert 0 < np.abs(got.pcm).max() < np.abs(track).max() // 8


def loopback(content, device):
    paths, _, short = content
    lb = watchdog(lambda: chip_smoke.songcast_loopback([paths["short"]],
                                                       device), 120.0)
    np.testing.assert_array_equal(lb["sent"].audio(), short)
    chip_smoke.loopback_gates(lb)
    assert lb["rx"].batcher.device.type == torch.device(device).type
    assert lb["tiles"] and lb["rx"].batcher.gain_tiles == len(lb["tiles"])
    return lb


def test_a_songcast_loopback_of_the_port(content):
    loopback(content, "cpu")


@pytest.mark.gpu
def test_a_songcast_loopback_on_the_card_matches_the_cpu(content):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = loopback(content, "cuda")
    cpu = loopback(content, "cpu")
    np.testing.assert_array_equal(card["sent"].audio(), cpu["sent"].audio())


def test_the_recorder_paces_frames_at_their_audio_clock():
    """A paced OhmRecorder holds each frame until its audio clock is within
    OHM_LEAD_S of the frame's start, so 0.5 s of frames takes ~0.45 s."""
    import time

    rec = chip_smoke.OhmRecorder(paced=True)
    x = np.ones((2, 1024), np.int32)
    t0 = time.monotonic()
    for i in range(22):
        rec.send_audio(x, 44100, 16, sample_start=1024 * i)
    wall = time.monotonic() - t0
    assert 21 * 1024 / 44100 - chip_smoke.OHM_LEAD_S - 0.02 < wall < 2.0
    assert rec.positions_run_on() and rec.audio().shape == (2, 22 * 1024)
    assert not rec.halt_after_audio
    rec.send_audio(0 * x, 44100, 16, sample_start=22 * 1024, halt=True)
    assert rec.halt_after_audio and rec.audio().shape == (2, 22 * 1024)


def test_silent_chunks_drop_as_the_recorder_drops_silent_frames():
    pcm = np.arange(2 * 5000, dtype=np.int32).reshape(2, 5000)
    pcm[:, 1024:2048] = 0
    pcm[:, 4096:] = 0
    kept = chip_smoke.drop_silent_chunks(pcm)
    np.testing.assert_array_equal(
        kept, np.concatenate([pcm[:, :1024], pcm[:, 2048:4096]], axis=1))
