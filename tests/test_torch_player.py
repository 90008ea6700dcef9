"""The port's player entry point (``ohpipeline_tpu_torch.tools.player``)
against the JAX package's ``tools/player.py``.

``main([... "--cpu", "--uri", uri, "--wav", out])`` runs in this process;
the JAX player runs as a subprocess on XLA-CPU, as
tests/test_player_cli.py runs it.  Both write a 44100 Hz / 16-bit WAV
whatever the stream.  A tone and a 2 s FLAC track give the same WAV bytes;
an MP3 gives the same header and PCM within 1 LSB (the port's MP3 bound
against the JAX package).  Each file decodes in one codec group: both
players use the default pipeline params and a free-running AnimatorBatch,
and a track of several groups starves the render at a group boundary
whenever the next group takes longer than the starvation ramper's 50 ms
wait (a FLAC group on the CPU takes ~1 s), so its WAV depends on timing in
either package.  Without a card a player that names no device exits
non-zero with ``KernelError`` before it builds anything."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.host.codecs.wav import parse_wav
from ohpipeline_tpu_torch.tools import player

ROOT = pathlib.Path(__file__).resolve().parent.parent
TONE = "tone://sine.wav?pitch=997&duration=1"
#: FLAC frames of 8192 samples: a 2 s track is 11 frames, one CodecFlac group
FLAC_BLOCK = 8192
#: an MP3 of 15 frames, one CodecMp3 group
MP3_SECONDS = 0.4
WAV_HEADER = 44


def jax_player(uri: str, out: pathlib.Path) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "player.py"), "--uri", uri,
         "--wav", str(out)], capture_output=True, timeout=600, env=env,
        cwd=str(ROOT))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r.stdout.decode()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("player")
    track = chip_smoke.make_track(2.0, 44100, 7)
    paths = {"flac": d / "a.flac", "mp3": d / "b.mp3"}
    paths["flac"].write_bytes(_host.encode_flac(track, 44100, 16,
                                                blocksize=FLAC_BLOCK))
    paths["mp3"].write_bytes(chip_smoke.mp3_bench_stream(0, MP3_SECONDS))
    return {k: f"file://{v}" for k, v in paths.items()}, track


def both(uri: str, tmp_path, capsys) -> tuple:
    """The port's and the JAX player's WAV bytes for ``uri``."""
    port, jax = tmp_path / "port.wav", tmp_path / "jax.wav"
    assert player.main(["--cpu", "--uri", uri, "--wav", str(port)]) == 0
    assert "rendered" in capsys.readouterr().out
    assert "rendered" in jax_player(uri, jax)
    return port.read_bytes(), jax.read_bytes()


def test_a_tone_writes_the_jax_players_wav(tmp_path, capsys):
    port, jax = both(TONE, tmp_path, capsys)
    assert port == jax
    info, pcm = parse_wav(port)
    assert info.sample_rate == 44100 and pcm.shape == (2, 44100)


def test_a_flac_track_writes_the_jax_players_wav(files, tmp_path, capsys):
    uris, track = files
    port, jax = both(uris["flac"], tmp_path, capsys)
    assert port == jax
    np.testing.assert_array_equal(parse_wav(port)[1], track)


def test_an_mp3_track_writes_the_jax_players_wav(files, tmp_path, capsys):
    uris, _ = files
    port, jax = both(uris["mp3"], tmp_path, capsys)
    assert port[:WAV_HEADER] == jax[:WAV_HEADER] and len(port) == len(jax)
    a, b = parse_wav(port)[1], parse_wav(jax)[1]
    assert a.shape[1] == 15 * 1152 and np.abs(a).max() > 1000
    assert int(np.abs(a.astype(np.int64) - b).max()) <= 1


def test_without_a_card_the_player_exits_naming_kernel_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "o.wav"
    r = subprocess.run(
        [sys.executable, "-m", "ohpipeline_tpu_torch.tools.player", "--uri",
         TONE, "--wav", str(out)], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT))
    assert r.returncode != 0
    assert "KernelError" in r.stderr and "no CUDA device" in r.stderr
    assert "[player]" not in r.stdout and not out.exists()
    with pytest.raises(_kernels.KernelError):
        player.main(["--uri", TONE, "--wav", str(out), "--device", "cuda"])


@pytest.mark.gpu
def test_the_player_on_the_card_writes_the_cpus_wav(files, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    uris, track = files
    wavs = []
    for flags in ([], ["--cpu"]):
        out = tmp_path / f"o{len(flags)}.wav"
        assert player.main(["--uri", uris["flac"], "--wav", str(out),
                            *flags]) == 0
        wavs.append(out.read_bytes())
    assert wavs[0] == wavs[1]
    np.testing.assert_array_equal(parse_wav(wavs[0])[1], track)
