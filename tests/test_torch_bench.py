"""The port's benches (``ohpipeline_tpu_torch.bench`` and
``ohpipeline_tpu_torch.bench_secondary``) on the CPU at a tiny size.

The content generators against the reference benches' (the repository
root's ``bench.make_track``, and ``bench_secondary.py``'s MP3, Vorbis and
all-codecs FLAC generators written out here with the JAX package's
encoders): equal bytes.  The headline's smoke run (2 + 2 streams, 1 pass)
must exit 0 with the FLAC stream bit-exact and the first AAC group within
rms 0.25 and max 1 LSB of float64 (the reference bench's gate,
``bench.py:971-973``); with no AAC content it must exit 1 with an error.
HE-AAC seconds count at the 44.1 kHz output rate, and the port's HE call
stays within 2 LSB of the JAX serving call on the bench's content (the
bound of ``test_torch_aac_he_serving.py``).  A device fault raised by a
serving call reaches the caller of the floor probe and of the all-codecs
aggregate with its own type.
"""

import numpy as np
import pytest

from ohpipeline_tpu_torch import _kernels, bench
from ohpipeline_tpu_torch import bench_secondary as bs
from ohpipeline_tpu_torch.codecs.aac import serving as aac_serving
from ohpipeline_tpu_torch.codecs.mp3 import serving as mp3_serving
from ohpipeline_tpu_torch.codecs.opus import celt

REPO = bs.ROOT


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    """Each test builds its content into its own cache, 0.3 s a stream for
    the secondary benches."""
    monkeypatch.setattr(bs, "CACHE", tmp_path / "cache")
    monkeypatch.setattr(bs, "SECONDS", 0.3)
    return tmp_path / "cache"


@pytest.fixture
def reference_bench(monkeypatch):
    """The repository root's bench.py (its top level imports numpy)."""
    monkeypatch.syspath_prepend(str(REPO))
    import bench as root_bench

    return root_bench


@pytest.mark.parametrize("seed", [7, 8, 22])
def test_make_track_equals_the_reference(reference_bench, seed):
    want = reference_bench.make_track(1.3, 44100, seed)
    got = bench.make_track(1.3, 44100, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _jax_mp3(i, secs):
    """bench_secondary.py:150-163 with the JAX package's encoder."""
    from ohpipeline_tpu.codecs.mp3 import encoder as ENC

    rng = np.random.default_rng(300 + i)
    frames = []
    for _ in range(int(secs * 44100 / 1152)):
        spec = np.zeros((2, 576), np.int32)
        m = rng.random((2, 576)) < 0.25
        spec[m] = rng.integers(1, 12, m.sum())
        frames.append(ENC.build_frame(
            [spec[0], spec[1]], global_gain=int(rng.integers(174, 184))))
    return b"".join(frames)


def _jax_vorbis(seed, secs):
    """bench_secondary.py:177-189 (seed 100 + i) and :476-490 (seed 7)
    with the JAX package's StreamSpec."""
    from ohpipeline_tpu.codecs.vorbis.encoder import StreamSpec

    rng = np.random.default_rng(seed)
    spec = StreamSpec(channels=2, sample_rate=44100, bs0=256, bs1=1024,
                      coupling=True)
    blocks = []
    for _ in range(int(secs * 44100 / 512)):
        r = np.zeros((2, 512), np.int64)
        m = rng.random((2, 512)) < 0.3
        r[m] = rng.integers(-2, 3, m.sum())
        blocks.append((1, [(140, 120)] * 2, r))
    return spec.build(blocks)


def _jax_mp3_sweep(secs):
    """bench_secondary.py:448-455 with the JAX package's encoder."""
    from ohpipeline_tpu.codecs.mp3 import encoder as ENC

    rng = np.random.default_rng(3)
    spec = np.zeros((2, 576), np.int32)
    m = rng.random((2, 576)) < 0.25
    spec[m] = rng.integers(1, 12, m.sum())
    return ENC.build_stream([spec[0], spec[1]],
                            nframes=int(secs * 44100 / 1152))


def _jax_flac(i, secs):
    """bench_secondary.py:231-239 with the JAX package's encoder."""
    from ohpipeline_tpu.codecs import flac as FL

    pcm = np.roll(bs._content(secs, 44100, stereo=True), 13 * i, axis=1)
    return FL.encode_flac(pcm, 44100, 16, blocksize=1024)


GENERATORS = {
    "mp3_0": (lambda: bs.mp3_stream(0, 0.5), lambda: _jax_mp3(0, 0.5)),
    "mp3_7": (lambda: bs.mp3_stream(7, 0.5), lambda: _jax_mp3(7, 0.5)),
    "vorbis_0": (lambda: bs.vorbis_stream(0, 0.5),
                 lambda: _jax_vorbis(100, 0.5)),
    "vorbis_9": (lambda: bs.vorbis_stream(9, 0.5),
                 lambda: _jax_vorbis(109, 0.5)),
    "mp3_sweep": (lambda: bs.mp3_sweep_stream(0.5),
                  lambda: _jax_mp3_sweep(0.5)),
    "vorbis_sweep": (lambda: bs.vorbis_sweep_stream(0.5),
                     lambda: _jax_vorbis(7, 0.5)),
    "flac_3": (lambda: bs.flac_stream(3, 0.3), lambda: _jax_flac(3, 0.3)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_equal_the_reference_benches(name):
    port, reference = GENERATORS[name]
    got = port()
    assert len(got) > 0 and got == reference()


def test_signal_equals_the_reference_sweeps(reference_bench):
    import bench_secondary as root_secondary

    for stereo in (True, False):
        assert np.array_equal(bs._content(0.2, 48000, stereo),
                              root_secondary._content(0.2, 48000, stereo))


def test_built_caches_what_it_builds(cache):
    jobs = [("mp3", 1, 0.2), ("vorbis", 2, 0.2)]
    first = bs.built(jobs)
    assert first == [bs.mp3_stream(1, 0.2), bs.vorbis_stream(2, 0.2)]
    assert len(list(cache.glob("*.bin"))) == 2
    assert bs.built(jobs) == first


def test_headline_smoke_passes_its_gates():
    rc, line = bench.run(2, 2, 1.5, 1, smoke=True, device="cpu")
    assert rc == 0, line
    assert line["metric"] == "flac_aac_decode_realtime_x"
    assert line["backend"] == "cpu" and line["card"] is None
    assert line["bit_exact_flac"] is True
    assert line["aac_rms_vs_f64"] <= 0.25 and line["aac_max_vs_f64"] <= 1.0
    assert line["flac_audio_s"] == 2 * 1.5
    assert line["aac_audio_s"] == 2 * np.ceil(1.5 * 44100 / 1024) * 1024 \
        / 44100
    assert line["passes_completed"] == 1 and line["value"] > 0
    assert line["aac_content"] == "tiled tests/assets/dryrun.aac"
    assert "error" not in line and "secondary_floor" not in line


def test_headline_without_aac_content_fails(monkeypatch):
    real = bs.read_asset
    monkeypatch.setattr(bs, "read_asset", lambda name: b"" if name ==
                        "dryrun.aac" else real(name))
    rc, line = bench.run(2, 2, 1.0, 1, smoke=True, device="cpu")
    assert rc == 1 and "aac" in line["error"] and line["value"] == 0.0


def test_main_prints_the_line_last(capsys, monkeypatch):
    real = bench.run
    monkeypatch.setattr(bench, "run", lambda *a, **k: real(
        2, 2, 1.0, 1, smoke=True, device="cpu"))
    assert bench.main(["--smoke", "--cpu"]) == 0
    import json

    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metric"] == "flac_aac_decode_realtime_x"
    assert last["bit_exact_flac"] is True


def test_he_seconds_count_at_the_output_rate():
    from ohpipeline_tpu.codecs.aac.serving import (
        decode_he_streams_device as jax_serving)

    streams = bs.he_streams(2, 1.0)
    assert bs.he_output_rate(streams) == 44100
    jobs = bs.serving_jobs({"he_aac": 2}, "cpu", 1.0)
    assert jobs["he_aac"][0] == streams
    outs = aac_serving.decode_he_streams_device(streams, device="cpu")
    want = jax_serving(streams)
    n_frames = int(np.ceil(1.0 * 22050 / 1024))
    for got, w in zip(outs, want):
        assert got.shape == w.shape == (2, n_frames * 2048)
        assert int(np.abs(got.astype(np.int64) - w).max()) <= 2
    assert jobs["he_aac"][2](outs) == 2 * n_frames * 2048 / 44100


def test_tiled_streams_follow_the_smoke_layout():
    """Stream s of the tiled AAC-LC, HE-AAC and CELT content starts where
    chip_smoke's does and cycles through the asset."""
    frames = bs._adts_frames(bs.read_asset("dryrun.aac"))
    s3 = bs.aac_streams(4, 5.0)[3]
    assert s3.startswith(b"".join(frames[3:])) and \
        s3[len(b"".join(frames[3:])):].startswith(frames[0])
    he = bs._adts_frames(bs.read_asset("dryrun_he.aac"))
    assert bs.he_streams(7, 0.5)[6].startswith(he[10])
    assert len(bs.celt_streams(2, 0.4)) == 2


class Fault:
    """A serving call that raises a device fault from its ``after``-th
    call on."""

    def __init__(self, real, after: int = 0):
        self.real, self.after, self.calls = real, after, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls > self.after:
            raise _kernels.KernelError("launch failed (injected)")
        return self.real(*args, **kwargs)


def test_a_device_fault_propagates_out_of_the_floor_probe(monkeypatch):
    monkeypatch.setattr(celt, "decode_celt_streams_device",
                        Fault(celt.decode_celt_streams_device))
    with pytest.raises(_kernels.KernelError, match="injected"):
        bs.floor_probe(passes=1, device="cpu")


def test_a_device_fault_in_a_thread_reaches_the_caller(monkeypatch):
    fault = Fault(mp3_serving.decode_mp3_streams_device, after=1)
    monkeypatch.setattr(mp3_serving, "decode_mp3_streams_device", fault)
    with pytest.raises(_kernels.KernelError, match="injected"):
        bs.all_codecs_bench(passes=1, device="cpu")
    assert fault.calls == 2          # the warm call, then the pass's


def test_the_sweep_runs_every_codec_it_has_content_for():
    line = bs.main(device="cpu", passes=1)
    assert line["metric"] == "secondary_codecs_realtime_x"
    assert set(line["codecs"]) == {
        "opus_celt_stereo", "opus_celt_16stream_device",
        "he_aac_v1_device_sbr", "he_aac_16stream_device", "mp3",
        "mp3_16stream_device", "vorbis", "vorbis_16stream_device"}
    assert all(v > 0 for v in line["codecs"].values())
    assert line["floor"] == min(line["codecs"].values())
    assert line["absent"] == {name: "no content in the repository" for name
                              in ("opus_silk_wb", "opus_silk_stereo",
                                  "opus_hybrid", "alac")}
