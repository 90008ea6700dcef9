"""Tests of the ``he_aac_radio`` configuration's own pieces, on the CPU at
small sizes: the faults its comparison must catch, its content, its
reference against the port's host SBR chain and against fdk-aac's decoder,
and its kernel work counts.

    python -m pytest ohp_bench/tests/test_he_aac_radio.py
"""

from __future__ import annotations

import math
import re
import subprocess

import numpy as np
import pytest
import torch

from ohp_bench import run
from ohp_bench.content import he_aac as content
from ohp_bench.reference import aac as R
from ohp_bench.reference import he_aac as H
from ohp_bench.tests.test_bench import ROOT, SEED, _cell, _cfg, _small
from ohp_bench.work import he_aac as work

CELL = "he_aac_radio.batch"


# ---------------------------------------------------------------------------
# faults a run must catch
# ---------------------------------------------------------------------------

def _state_not_carried(monkeypatch):
    """Every group starts the SBR from its initial state, as a new
    ``SbrDeviceRunner`` would (the LC core's overlap is kept)."""
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd

    real = sbrd.SbrDeviceRunner.decode_group_multi_zz

    def fresh(self, planes, per_ch, consts):
        core_ov = self._core_ov
        self.__init__(self.dec, len(per_ch), device=self.device)
        self._core_ov = core_ov
        return real(self, planes, per_ch, consts)

    monkeypatch.setattr(sbrd.SbrDeviceRunner, "decode_group_multi_zz", fresh)


def _sbr_skipped(monkeypatch):
    """The core PCM, each sample repeated, in place of the SBR stage's
    output."""
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd

    def upsampled(static, pcm, cond, state):
        C = pcm.shape[0]
        return pcm.repeat_interleave(2, dim=-1).reshape(C, -1), state

    monkeypatch.setattr(sbrd, "device_decode_group", upsampled)


def _channels_swapped(monkeypatch):
    """Stream 0's SBR frames on stream 1's channels and the reverse."""
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd

    real = sbrd.SbrDeviceRunner.decode_group_multi_zz

    def swapped(self, planes, per_ch, consts):
        return real(self, planes, per_ch[2:4] + per_ch[0:2] + per_ch[4:],
                    consts)

    monkeypatch.setattr(sbrd.SbrDeviceRunner, "decode_group_multi_zz",
                        swapped)


@pytest.mark.parametrize("fault", [_state_not_carried, _sbr_skipped,
                                   _channels_swapped],
                         ids=["state_not_carried", "sbr_skipped",
                              "channels_swapped"])
def test_a_fault_in_the_sbr_stage_comes_out_not_correct(fault, monkeypatch):
    small = _small(CELL)
    assert small["stream_seconds"] * 44100 / 2048 > _cell(CELL)[
        "frames_per_group"]                 # two groups: a state carried
    fault(monkeypatch)
    line = run.run_cell(CELL, SEED, 0.5, False, "cpu", small)
    assert not line["correct"], line["checks"]


# ---------------------------------------------------------------------------
# content
# ---------------------------------------------------------------------------

def _has_sbr_header(frame: bytes) -> bool:
    payload, nbits, crc = H.sbr_payload(frame)
    b = H.Bits(payload, 0, nbits)
    if crc:
        b.read(10)
    return bool(b.read(1))


def test_the_asset_has_a_header_at_each_segment_start_and_nowhere_else():
    frames = content.asset_frames()
    assert len(frames) == 46 and sum(map(len, frames)) == 13405
    heads = [i for i, f in enumerate(frames) if _has_sbr_header(f)]
    assert heads == [a for a, _ in content.SEGMENTS]
    assert content.SEGMENTS[-1][1] == len(frames)


@pytest.mark.parametrize("seconds", [3.0, 20.0])
def test_streams_are_distinct_start_at_a_header_and_repeat_for_a_seed(
        seconds):
    cell = {**run.load_json(ROOT / "workloads" / f"{CELL}.json"),
            "stream_seconds": seconds}
    a = content.make(_cfg(cell), cell, SEED)
    b = content.make(_cfg(cell), cell, SEED)
    assert a == b
    assert a != content.make(_cfg(cell), cell, SEED + 1)
    streams = a["streams"]
    assert len(set(streams)) == len(streams) == 32
    n = math.ceil(seconds * 44100 / 2048)
    asset = content.asset_frames()
    heads = {asset[s] for s, _ in content.SEGMENTS}
    for s in streams:
        frames = R.split_frames(s)
        assert len(frames) == n and frames[0] in heads
        assert set(frames) <= set(asset)
    assert len(a["check"]) == cell["check_streams"] == 4
    assert a["check"] == sorted(set(a["check"]))
    assert all(0 <= i < 32 for i in a["check"])


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def test_the_reference_and_content_import_neither_the_port_nor_jax():
    for path in (ROOT / "reference" / "he_aac.py",
                 ROOT / "content" / "he_aac.py",
                 ROOT / "work" / "he_aac.py"):
        lines = [ln for ln in path.read_text().splitlines()
                 if re.match(r"\s*(import|from)\s", ln)]
        assert lines, path
        for ln in lines:
            assert not re.search(r"\b(jax|jaxlib|flax|ohpipeline_tpu\w*)\b",
                                 ln), (path, ln)


def test_the_reference_is_the_port_host_chain_fed_the_same_core():
    """The frozen, vectorised copy against the port's numpy float64 chain
    (``host/codecs/aac/sbr.py``) on the same core PCM: equal but for the
    order of float64 sums, on a stream with every segment join."""
    from ohpipeline_tpu_torch._host import aac_sbr as SBR

    frames = content.asset_frames()
    order = [0, 4, 1, 3, 2, 1, 0, 2, 4, 3]
    data = content.segment_stream(frames, order, 10 ** 6)
    cell = _cell(CELL)
    ref = H.decode_stream(data, cell)
    core = R.Decoder().decode_stream(data, R.pns_rows("serving", cell))
    dec = SBR.SbrDecoder(22050)
    outs = []
    for f, frame in enumerate(R.split_frames(data)):
        payload, nbits, crc = H.sbr_payload(frame)
        chans, coupling = dec.parse_payload(payload, nbits, stereo=True,
                                            crc=crc)
        outs.append(dec.process_frame(core[:, f * 1024:(f + 1) * 1024],
                                      chans, coupling))
    host = np.concatenate(outs, axis=1)
    assert ref.dtype == np.float64 and ref.shape == host.shape
    assert np.abs(ref - host).max() < 1e-6 * np.abs(host).max()


#: fdk-aac's decoder (libSBRdec in its complex-QMF chain), which ohPipeline
#: plays HE-AAC through, built by ``tools/build_oracles.sh`` from the
#: vendored sources; the test below skips where they were not at hand.
ORACLE = ROOT.parent / ".oracle_build" / "aac_oracle"
#: The lowest per-sample SNR ``tests/test_sbr.py`` holds an HE-AAC v1
#: decode to against the same oracle (its conformance test, noise).
FDK_SNR_DB = 30.0


def _fdk_decode(data: bytes, tmp) -> np.ndarray:
    src, out = tmp / "in.aac", tmp / "out.raw"
    src.write_bytes(data)
    subprocess.run([str(ORACLE), "decode", str(src), str(out)], check=True,
                   capture_output=True)
    return np.fromfile(out, np.int16).reshape(-1, 2).T.astype(np.float64)


def _snr_db(a: np.ndarray, b: np.ndarray) -> float:
    return 10 * np.log10((a * a).sum() / max(((a - b) ** 2).sum(), 1e-9))


@pytest.mark.skipif(not ORACLE.exists(),
                    reason="fdk-aac oracle not built (tools/build_oracles.sh)")
@pytest.mark.parametrize("order", [[0, 1, 2, 3, 4], [2, 1]],
                         ids=["asset", "frames_20_29_then_10_19"])
def test_the_reference_tracks_fdk_aac(order, tmp_path):
    """A second witness besides the port's own host chain: fdk-aac decodes
    the asset, and a stream joined at a header frame (frames 20-29, then
    10-19), within the conformance SNR, over the stream and over the four
    frames from the join on.  fdk's output lags by its decoder delay, so
    the reference is held to it at the lag that correlates best."""
    data = content.segment_stream(content.asset_frames(), order, 10 ** 6)
    ref = H.decode_stream(data, _cell(CELL))
    fdk = _fdk_decode(data, tmp_path)
    n = min(ref.shape[1], fdk.shape[1]) - 4096
    assert n >= 12288

    def window(lag, a, b):                  # ref's [a, b) against fdk's
        return ref[:, a:b], fdk[:, a + lag:b + lag]

    # the lag in [-4096, 4096] at which the two correlate best
    x, y = ref[:, 4096:n].sum(0), fdk[:, :n + 4096].sum(0)
    size = len(x) + len(y)
    corr = np.fft.irfft(np.fft.rfft(y, size)
                        * np.conj(np.fft.rfft(x, size)), size)
    lag = int(np.argmax(corr[:8193])) - 4096
    assert _snr_db(*window(lag, 4096, n)) >= FDK_SNR_DB
    join = 2048 * (content.SEGMENTS[order[0]][1]
                   - content.SEGMENTS[order[0]][0])
    if join < n:
        assert _snr_db(*window(lag, join, min(join + 4 * 2048, n))) \
            >= FDK_SNR_DB


def test_the_sbr_stage_runs_in_float64_with_tf32_off(monkeypatch):
    seen = []
    real = H.analysis

    def analysis(pcm, matmul):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        out = real(pcm, matmul)
        assert out.dtype == torch.complex128
        return out

    monkeypatch.setattr(H, "analysis", analysis)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    frames = content.asset_frames()
    H.decode_stream(b"".join(frames[:3]), _cell(CELL))
    assert seen == [(False, False)] * 2
    assert torch.backends.cuda.matmul.allow_tf32      # restored after


def test_compare_holds_every_output_of_a_checked_stream_and_no_other():
    frames = content.asset_frames()
    streams = [b"".join(frames[a:a + 4]) for a in (0, 10, 20)]
    cell = _cell(CELL)
    c = {"streams": streams, "check": [1]}
    ref = H.decode_stream(streams[1], cell)
    good = np.clip(np.rint(ref), -32768, 32767).astype(np.int32)
    bad = good.copy()
    bad[0, 100] += 64
    assert H.compare(c, [(1, good), (0, bad)], "serving",
                     cell)["pcm_gap_lsb"] <= 0.5
    assert H.compare(c, [(1, good), (1, bad)], "serving",
                     cell)["pcm_gap_lsb"] >= 63


# ---------------------------------------------------------------------------
# work
# ---------------------------------------------------------------------------

def test_work_is_a_hand_count_of_the_kernel_on_one_group():
    """One group (F = 48) of two streams of 22 frames: the bytes of every
    tensor ``_kernels.sbr_env`` checks, and the kernel's adjusted slots
    counted thread by thread as ``csrc/sbr_env.cu`` walks them."""
    frames = content.asset_frames()
    streams = [content.segment_stream(frames, o, 22)
               for o in ([1, 0, 2], [4, 3, 0])]
    cell = {**_cell(CELL), "streams": 2}
    F, C = cell["frames_per_group"], 4
    M = work.band_count(streams[0])
    got = work.per_request({"streams": streams}, cell)["sbr_env_map"]

    f32, i8, i32 = 4, 1, 4
    shapes = [((C, F, 8, M), f32)] * 4 + [((C, F, 38), i8)] * 2 \
        + [((C, F), i8)] + [((C, F, 38), f32)] * 2 + [((C, F, 38), i32)] \
        + [((C,), i32)] * 2 + [((C, F, 8), f32)] + [((512,), f32)] * 2 \
        + [((M,), f32)] + [((C, F, 38, M), f32)] * 2 \
        + [((C, 2, M), f32)] + [((C, 6, M), f32)] * 2 \
        + [((C, F, 32, M), f32)] * 2 + [((C, 2, M), f32)] \
        + [((C, 6, M), f32)] * 2
    assert got["bytes"] == sum(int(np.prod(s)) * n for s, n in shapes)

    # env_id and carry_mask as the cond build lays them, from the grids
    env = np.full((C, F, 38), -1)
    carry = np.zeros((C, F, 38), bool)
    for si, s in enumerate(streams):
        dec = H.SbrDecoder(22050)
        for f, frame in enumerate(R.split_frames(s)):
            chans, _ = dec.parse(*H.sbr_payload(frame)[:2], stereo=True,
                                 crc=H.sbr_payload(frame)[2])
            for c, ch in enumerate(chans):
                t = ch.grid.t_env
                carry[2 * si + c, f, :min(2 * t[0], 38)] = True
                for e in range(ch.grid.n_env):
                    env[2 * si + c, f,
                        min(2 * t[e], 38):min(2 * t[e + 1], 38)] = e
    adjusted = 0
    for c in range(C):
        for f in range(F):
            for s in range(38):
                if s >= 32 and f < F - 1:
                    continue            # frame f + 1's tail
                if carry[c, f, s] and s < 6 and f > 0:
                    adjusted += env[c, f - 1, 32 + s] >= 0
                adjusted += env[c, f, s] >= 0
    assert got["ops"] == 29 * M * adjusted > 0
