"""The port's render path on the CPU: ``PipelineManager.play_uri`` -> codec
controller -> decoded reservoir -> render chain -> animator, against the
input and against the JAX pipeline.

The flows of tests/test_pipeline_e2e.py run on the port (tone within 4 zero
crossings, WAV and FLAC bit-exact, FLAC through the native and the Python
frame parser); the ADTS assets through the port's pipeline stay within 1
LSB (AAC-LC) and 2 LSB (HE-AAC) of the JAX pipeline; a play paused and
played again, and the RenderBatcher alone, are bit-exact with the JAX
batcher on XLA-CPU (``use_device=True``: the port's apply_gain fuses the
ramp line's multiply-add as XLA does).  The codec controller keeps the JAX
contract for hostile input (tests/test_codec_controller_hostile.py) and
hands a device fault to the animator's caller instead.  Every animator run
goes through :func:`watchdog`, so a hang fails the test."""

import functools
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch import pipeline as tp
from ohpipeline_tpu_torch.codecs import aac as aac_codec
from ohpipeline_tpu_torch.codecs import default_registry
from ohpipeline_tpu_torch.codecs import flac as flac_codec
from ohpipeline_tpu_torch.codecs.mp3 import synthesis as mp3_synthesis
from ohpipeline_tpu_torch.host.codecs import base as hbase
from ohpipeline_tpu_torch.host.codecs.wav import write_wav
from ohpipeline_tpu_torch.host.core import events as hev
from ohpipeline_tpu_torch.host.core.ramp import Ramp, RampDirection
from ohpipeline_tpu_torch.host.core.streaminfo import (EncodedStreamInfo,
                                                       PcmStreamInfo)
from ohpipeline_tpu_torch.host.pipeline import manager as hmanager
from ohpipeline_tpu_torch.host.pipeline.codec_controller import (
    CodecController)
from ohpipeline_tpu_torch.ops import lpc as lpc_ops

ASSETS = chip_smoke.HERE + "/tests/assets"
LIMIT_S = 120.0


def watchdog(fn, timeout: float = LIMIT_S):
    """fn() on a thread joined with a time limit: fails the test if it has
    not returned by then, and raises what fn raised."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as exc:                   # noqa: BLE001
            out["error"] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"the run did not end within {timeout} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _params():
    return chip_smoke.render_params(tp.PipelineInitParams())


def _play(uri: str, mgr=None, kinds=None) -> chip_smoke.Sink:
    """Plays ``uri`` to its halt through ``mgr`` (the port's facade on the
    CPU by default) and an AnimatorBatch on the CPU; ``kinds`` collects the
    kind of every event the animator pulled."""
    mgr = mgr or tp.PipelineManager(_params(), device="cpu")
    sink = chip_smoke.Sink()
    try:
        anim = tp.AnimatorBatch(mgr.pipeline.predriver, sink, device="cpu")
        if kinds is not None:
            anim.pipeline = _Recorder(anim.pipeline, kinds)
        mgr.play_uri(uri)
        watchdog(anim.run)
    finally:
        mgr.quit()
    return sink


class _Recorder:
    def __init__(self, upstream, kinds):
        self._up, self._kinds = upstream, kinds

    def pull(self):
        e = self._up.pull()
        self._kinds.append(e.kind)
        return e


def _jax_play(uri: str, ramp_before: int = 0):
    """The same play through the JAX package's pipeline, its AnimatorBatch
    on XLA-CPU (use_device=True)."""
    from ohpipeline_tpu.pipeline import AnimatorBatch, PipelineManager
    from ohpipeline_tpu.pipeline.manager import PipelineInitParams

    mgr = PipelineManager(chip_smoke.render_params(PipelineInitParams()))
    sink = chip_smoke.Sink()
    try:
        anim = AnimatorBatch(mgr.pipeline.predriver, sink, use_device=True)
        if ramp_before:
            watchdog(lambda: chip_smoke.ramp_play(mgr, anim, uri,
                                                  ramp_before))
        else:
            mgr.play_uri(uri)
            watchdog(anim.run)
    finally:
        mgr.quit()
    return sink


def _stereo_tone(seconds: float, rate: int = 44100, amp: float = 28000):
    t = np.arange(int(seconds * rate)) / rate
    return np.stack([np.rint(np.sin(2 * np.pi * 997 * t) * amp),
                     np.rint(np.sin(2 * np.pi * 1009 * t) * amp)]
                    ).astype(np.int32)


def zero_crossings(x):
    s = np.signbit(x.astype(np.int64))
    return int(np.count_nonzero(s[1:] != s[:-1]))


def test_tone_uri_end_to_end():
    sink = _play("tone://sine.wav?pitch=1000&duration=2&samplerate=44100"
                 "&bitdepth=16&channels=2")
    assert sink.pcm.shape == (2, 88200)
    zc = zero_crossings(sink.pcm[0])
    assert abs(zc - 4000) <= 4, zc


def test_file_wav_end_to_end(tmp_path):
    t = np.arange(44100) / 44100
    tone = np.tile(np.rint(np.sin(2 * np.pi * 997 * t) * 30000)
                   .astype(np.int32), (2, 1))
    path = tmp_path / "t.wav"
    path.write_bytes(write_wav(tone, 44100, 16))
    np.testing.assert_array_equal(_play(f"file://{path}").pcm, tone)


@pytest.mark.parametrize("use_native", [True, False])
def test_file_flac_end_to_end(tmp_path, use_native):
    tone = _stereo_tone(1.0)
    path = tmp_path / "t.flac"
    path.write_bytes(_host.encode_flac(tone, 44100, 16))
    reg = hbase.CodecRegistry()
    reg.add(functools.partial(flac_codec.CodecFlac, use_native=use_native,
                              device="cpu"))
    mgr = hmanager.PipelineManager(_params(), reg)
    sink = _play(f"file://{path}", mgr)
    np.testing.assert_array_equal(sink.pcm, tone)
    assert sink.infos[0].codec_name == "FLAC"


def test_the_registry_follows_the_jax_order():
    from ohpipeline_tpu.codecs import default_registry as jax_registry

    def names(codecs):
        return [(type(c).__name__, c.name, c.recognition_cost)
                for c in codecs]

    port = default_registry("cpu").instantiate()
    assert names(port) == names(jax_registry.instantiate())
    assert len(port) == 13
    on_device = {type(c).__name__ for c in port if hasattr(c, "_device")}
    assert on_device == {"CodecFlac", "CodecAacMp4", "CodecAacAdts",
                         "CodecMp3"}
    assert all(c._device == torch.device("cpu") for c in port
               if hasattr(c, "_device"))


def test_an_unported_format_is_a_stream_interruption(tmp_path):
    """A byte stream that no plug-in of the registry recognises (seeded
    bytes with no container, sync word or magic any plug-in sniffs) is
    interrupted by the controller, as the JAX one interrupts a stream no
    plug-in takes."""
    from ohpipeline_tpu.codecs import default_registry as jax_registry

    data = np.random.default_rng(5).integers(0, 256, 64 * 1024,
                                             dtype=np.uint8).tobytes()
    assert default_registry("cpu").recognise(data) is None
    assert jax_registry.recognise(data) is None
    path = tmp_path / "t.bin"
    path.write_bytes(data)
    kinds = []
    sink = _play(f"file://{path}", kinds=kinds)
    assert sink.chunks == [] and "decoded_stream" not in kinds
    assert "halt" in kinds


@pytest.mark.parametrize("asset,lsb_max", [("dryrun.aac", 1),
                                           ("dryrun_he.aac", 2)])
def test_adts_matches_the_jax_pipeline(asset, lsb_max):
    uri = f"file://{ASSETS}/{asset}"
    port, jax = _play(uri), _jax_play(uri)
    assert port.pcm.shape == jax.pcm.shape and port.pcm.any()
    for a, b in ((port.infos[0], jax.infos[0]),):
        assert (a.codec_name, a.sample_rate) == (b.codec_name, b.sample_rate)
    lsb = int(np.abs(port.pcm.astype(np.int64) - jax.pcm).max())
    assert lsb <= lsb_max, lsb


def test_pause_and_play_ramps_match_the_jax_pipeline(tmp_path):
    tone = _stereo_tone(2.0)
    path = tmp_path / "t.flac"
    path.write_bytes(_host.encode_flac(tone, 44100, 16, blocksize=1024))
    uri = f"file://{path}"
    mgr = tp.PipelineManager(_params(), device="cpu")
    sink = chip_smoke.Sink()
    try:
        anim = tp.AnimatorBatch(mgr.pipeline.predriver, sink, device="cpu")
        watchdog(lambda: chip_smoke.ramp_play(mgr, anim, uri, 3))
    finally:
        mgr.quit()
    assert anim.batcher.gain_tiles > 0
    assert sink.pcm.shape == tone.shape
    assert (sink.pcm != tone).any(axis=0).sum() > 22050   # both ramps
    jax = _jax_play(uri, ramp_before=3)
    np.testing.assert_array_equal(sink.pcm, jax.pcm)


def _events(seed: int, kind: str) -> list:
    """Seeded AudioPcmEvents of mixed channel counts and lengths; ``kind``
    picks their gains: ramps up and down with attenuations, unity, or
    attenuation only."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(1, 7))):
        c, n = int(rng.integers(1, 3)), int(rng.integers(1, 3000))
        bits = int(rng.choice([16, 24]))
        info = PcmStreamInfo(44100, bits, c)
        x = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (c, n))
        e = hev.AudioPcmEvent(x.astype(np.int32), info)
        if kind == "ramps" and rng.random() < 0.7:
            a, b = sorted(rng.integers(0, 1 << 14, 2).tolist())
            d = RampDirection.UP if rng.random() < 0.5 else RampDirection.DOWN
            e.ramp = Ramp(a, b, d, True) if d is RampDirection.UP \
                else Ramp(b, a, d, True)
        if kind in ("ramps", "attenuation") and rng.random() < 0.6:
            e.attenuation = int(rng.integers(0, 1 << 14))
        out.append(e)
    return out


@pytest.mark.parametrize("seed,kind", [(s, k) for s in range(4)
                                       for k in ("ramps", "unity",
                                                 "attenuation")])
def test_render_batcher_matches_jax(seed, kind):
    from ohpipeline_tpu.core import events as jev
    from ohpipeline_tpu.core.ramp import Ramp as JRamp
    from ohpipeline_tpu.core.ramp import RampDirection as JDir
    from ohpipeline_tpu.core.streaminfo import PcmStreamInfo as JInfo
    from ohpipeline_tpu.pipeline.animator import RenderBatcher as JBatcher

    events = _events(seed, kind)
    jevents = []
    for e in events:
        i = e.info
        j = jev.AudioPcmEvent(e.samples.copy(), JInfo(i.sample_rate,
                                                      i.bit_depth,
                                                      i.num_channels))
        if e.ramp.enabled:
            j.ramp = JRamp(e.ramp.start, e.ramp.end,
                           JDir[e.ramp.direction.name], True)
        j.attenuation = e.attenuation
        jevents.append(j)
    batcher = tp.RenderBatcher("cpu")
    got = batcher.render(events)
    want = JBatcher(use_device=True).render(jevents)
    assert len(got) == len(want) == len(events)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    gained = any(e.ramp.enabled or e.attenuation != 1 << 14
                 for e in events)
    assert gained == (kind != "unity")
    assert batcher.gain_tiles == int(gained)
    if not gained:
        assert all(g is e.samples for g, e in zip(got, events))


# --- the codec controller: hostile input and device faults ---------------

class _NoContainers:
    def process(self, reader):
        return reader, {}


class _Upstream:
    def __init__(self, events):
        self._events = list(events)

    def pull(self):
        if self._events:
            return self._events.pop(0)
        return hev.HaltEvent()


class _BlowsUpMidStream(hbase.CodecBase):
    """Recognises anything; emits one good batch, then raises ``error``."""

    name = "boom"
    recognition_cost = 1
    error = RuntimeError("decoder bug on hostile input")

    def __init__(self):
        self._calls = 0

    def recognise(self, header: bytes) -> bool:
        return True

    def stream_initialise(self, reader):
        reader.read(4)
        return PcmStreamInfo(44100, 16, 2, codec_name="boom")

    def process(self, reader):
        self._calls += 1
        if self._calls == 1:
            return hbase.DecodedBatch(
                PcmStreamInfo(44100, 16, 2, codec_name="boom"),
                samples=np.ones((2, 64), np.int32), track_offset_samples=0)
        raise self.error


class _BlowsUpAtInit(_BlowsUpMidStream):
    def stream_initialise(self, reader):
        raise self.error


class _BlowsUpInDefer(_BlowsUpMidStream):
    def process(self, reader):
        self._calls += 1
        if self._calls == 1:
            def boom():
                raise self.error
            return hbase.DecodedBatch(
                PcmStreamInfo(44100, 16, 2, codec_name="boom"),
                defer=boom, track_offset_samples=0)
        raise hbase.EndOfStream


def _controller(codec_cls):
    reg = hbase.CodecRegistry()
    reg.add(codec_cls)
    return CodecController(_Upstream([
        hev.EncodedStreamEvent(EncodedStreamInfo(uri="hostile://x")),
        hev.EncodedAudioEvent(b"\x00" * 4096),
        hev.EncodedAudioEvent(b"\x00" * 4096)]), reg,
        containers=_NoContainers())


def test_unexpected_process_error_interrupts_not_crashes():
    cc = _controller(_BlowsUpMidStream)
    kinds = [cc.pull().kind for _ in range(8)]
    assert "decoded_stream" in kinds
    assert "audio_pcm" in kinds            # the good batch got through
    i = kinds.index("stream_interrupted")  # then corruption, no raise
    assert "halt" in kinds[i:]


def test_unexpected_init_error_interrupts_not_crashes():
    cc = _controller(_BlowsUpAtInit)
    kinds = [cc.pull().kind for _ in range(6)]
    assert "stream_interrupted" in kinds
    assert "decoded_stream" not in kinds
    assert "halt" in kinds


def test_deferred_batch_error_interrupts_not_crashes():
    cc = _controller(_BlowsUpInDefer)
    kinds = [cc.pull().kind for _ in range(6)]
    assert "stream_interrupted" in kinds
    assert "halt" in kinds


@pytest.mark.parametrize("where", [_BlowsUpMidStream, _BlowsUpAtInit,
                                   _BlowsUpInDefer])
@pytest.mark.parametrize("error", [
    _kernels.KernelError("lpc kernel launch failed: CUDA error 700"),
    _kernels.KernelArgumentError("data: want contiguous int32"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    AssertionError("Torch not compiled with CUDA enabled")])
def test_a_device_fault_is_not_stream_corruption(where, error):
    codec = type("Faulty", (where,), {"error": error})
    cc = _controller(codec)
    kinds = []
    with pytest.raises(type(error)):
        for _ in range(8):
            kinds.append(cc.pull().kind)
    assert "stream_interrupted" not in kinds


def test_device_faults_are_told_from_other_errors():
    assert _kernels.is_device_fault(_kernels.KernelError("x"))
    assert isinstance(_kernels.KernelArgumentError("x"), ValueError)
    assert _kernels.is_device_fault(torch.cuda.OutOfMemoryError("x"))
    assert not _kernels.is_device_fault(RuntimeError("decoder bug"))
    assert not _kernels.is_device_fault(ValueError("bad header"))
    assert not _kernels.is_device_fault(KeyError("CUDA"))


def _raise_kernel_error(*args, **kwargs):
    raise _kernels.KernelError("kernel launch failed: CUDA error 719")


def _fault_run(uri: str, animator: str = "batch"):
    """Plays ``uri`` on the port's facade (CPU) with a kernel fault on the
    pump thread; returns (the error the animator's caller got, the kinds
    the animator pulled)."""
    kinds = []
    mgr = tp.PipelineManager(_params(), device="cpu")
    try:
        sink = chip_smoke.Sink()
        pull = _Recorder(mgr.pipeline.predriver, kinds)
        if animator == "batch":
            anim = tp.AnimatorBatch(pull, sink, device="cpu")
            mgr.play_uri(uri)
            run = anim.run
        else:
            anim = tp.AnimatorBasic(pull, sink, device="cpu", realtime=False)
            mgr.play_uri(uri)
            anim.start()

            def run():
                anim.join(LIMIT_S)
                assert not anim.is_alive()
        with pytest.raises(_kernels.KernelError) as info:
            watchdog(run)
        assert isinstance(mgr.pipeline.fault, _kernels.KernelError)
    finally:
        mgr.quit()
    return info.value, kinds


@pytest.mark.parametrize("animator,stream", [
    pytest.param("batch", "flac", id="batch"),
    pytest.param("basic", "flac", id="basic"),
    pytest.param("batch", "m4a", id="batch-m4a"),
    pytest.param("basic", "m4a", id="basic-m4a"),
    pytest.param("batch", "m4a_he", id="batch-m4a_he"),
    pytest.param("batch", "mp3", id="batch-mp3")])
def test_a_kernel_fault_on_the_pump_thread_reaches_the_animator(
        tmp_path, monkeypatch, animator, stream):
    """A FLAC stream faults in the LPC kernel; an AAC-LC M4A stream in its
    deferred batch's filterbank, which runs when the controller resolves
    the batch on the pump thread; an HE-AAC M4A in its SBR group; an MP3
    stream in the window kernel of its first group."""
    path = tmp_path / f"t.{stream}"
    if stream == "flac":
        path.write_bytes(_host.encode_flac(_stereo_tone(0.5), 44100, 16))
        monkeypatch.setattr(lpc_ops, "lpc_synthesize", _raise_kernel_error)
    elif stream == "m4a":
        path.write_bytes(chip_smoke.m4a_from_adts(f"{ASSETS}/dryrun.aac"))
        monkeypatch.setattr(aac_codec.SYN, "filterbank", _raise_kernel_error)
    elif stream == "m4a_he":
        path.write_bytes(chip_smoke.m4a_from_adts(f"{ASSETS}/dryrun_he.aac",
                                                  True))
        monkeypatch.setattr(aac_codec, "_sbr_decode_frames_lazy",
                            _raise_kernel_error)
    else:
        path.write_bytes(chip_smoke.mp3_bench_stream(0, 1.0))
        monkeypatch.setattr(mp3_synthesis, "mp3_window", _raise_kernel_error)
    err, kinds = _fault_run(f"file://{path}", animator)
    assert "CUDA error 719" in str(err)
    assert "stream_interrupted" not in kinds and "audio_pcm" not in kinds


def test_a_kernel_fault_in_the_sbr_path_reaches_the_animator(monkeypatch):
    monkeypatch.setattr(aac_codec, "_sbr_decode_frames_lazy",
                        _raise_kernel_error)
    err, kinds = _fault_run(f"file://{ASSETS}/dryrun_he.aac")
    assert "CUDA error 719" in str(err)
    assert "stream_interrupted" not in kinds


def test_the_silencer_fills_halts_and_hands_on_an_upstream_error():
    info = PcmStreamInfo(44100, 16, 2)
    audio = hev.AudioPcmEvent(np.ones((2, 64), np.int32), info)
    gate = threading.Event()

    class Upstream:
        def __init__(self):
            self._events = [hev.DecodedStreamEvent(1, info), audio,
                            hev.HaltEvent()]

        def pull(self):
            if self._events:
                return self._events.pop(0)
            gate.wait(LIMIT_S)
            raise _kernels.KernelError("kernel launch failed")

    silencer = tp.Silencer(Upstream())

    def run():
        kinds = [silencer.pull().kind for _ in range(2)]
        # the halt is swallowed, and silence follows it
        while not (silencer.pull().kind == "silence" and silencer.halted):
            pass
        gate.set()
        while True:
            e = silencer.pull()
            if e.kind == "quit":
                return kinds, e
    kinds, end = watchdog(run)
    assert kinds == ["decoded_stream", "audio_pcm"]
    assert isinstance(end, tp.DecodeFaultEvent)
    assert isinstance(end.error, _kernels.KernelError)


def test_realtime_animator_delivers_the_track(tmp_path):
    tone = _stereo_tone(1.0)
    path = tmp_path / "t.flac"
    path.write_bytes(_host.encode_flac(tone, 44100, 16, blocksize=1024))
    pcm, _fill, anim, _wall = watchdog(lambda: chip_smoke.realtime_play(
        str(path), "cpu", tone.shape[1]))
    np.testing.assert_array_equal(pcm, tone)
    assert anim.late_quanta >= 0 and not anim.is_alive()


def test_without_a_card_the_facade_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import inspect

    for fn in (tp.PipelineManager, tp.RenderBatcher, default_registry):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        with pytest.raises(_kernels.KernelError):
            fn()


@pytest.mark.gpu
def test_flac_and_ramp_flows_on_the_card_equal_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tone = _stereo_tone(2.0)
    path = tmp_path / "t.flac"
    path.write_bytes(_host.encode_flac(tone, 44100, 16, blocksize=1024))
    _kernels.reset_launches()
    card, _, _ = watchdog(lambda: chip_smoke.render_play(str(path), "cuda"))
    assert _kernels.launches["lpc"] > 0
    np.testing.assert_array_equal(card.pcm, tone)
    for before in (3, 5):
        got, _, batcher = watchdog(lambda: chip_smoke.render_play(
            str(path), "cuda", ramp_before=before))
        want, _, _ = watchdog(lambda: chip_smoke.render_play(
            str(path), "cpu", ramp_before=before))
        assert batcher.gain_tiles > 0
        np.testing.assert_array_equal(got.pcm, want.pcm)
