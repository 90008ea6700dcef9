"""Float32 matrix products of the port are full float32 or refused.

``_kernels.require_full_fp32(device)`` raises ``KernelError`` for a CUDA
device whenever float32 matmuls there may run in TF32 (the reference pins
``Precision.HIGHEST``): its decision over torch's newer
``fp32_precision`` settings and the legacy flags, with those attributes
replaced by stand-ins (a legacy read raises once the newer API is set, as
torch does, so the check must not reach it then); that every device
function of the port that issues float products calls it, on the CPU; and,
on the card (``gpu``), that the AAC and MP3 serving calls refuse with TF32
turned on through either API, the flags restored afterwards.
"""

import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.codecs import aac
from ohpipeline_tpu_torch.codecs.aac import serving as aac_serving
from ohpipeline_tpu_torch.codecs.mp3 import serving as mp3_serving

ASSETS = pathlib.Path(__file__).resolve().parent / "assets"
MIXED = "mix of the legacy and new APIs"


class Matmul:
    """Stand-in for ``torch.backends.cuda.matmul``: the newer per-backend
    setting (absent when None) and the legacy flag, which raises after the
    newer API was set, as torch's does."""

    def __init__(self, new, allow_tf32, mixed):
        if new is not None:
            self.fp32_precision = new
        self._allow, self._mixed = allow_tf32, mixed

    @property
    def allow_tf32(self):
        if self._mixed:
            raise RuntimeError(MIXED)
        return self._allow


def _backends(matmul_new, generic, allow_tf32=False, precision="highest",
              monkeypatch=None):
    mixed = matmul_new not in (None, "none") or generic not in (None, "none")
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        matmul=Matmul(matmul_new, allow_tf32, mixed)))
    if generic is not None:
        fake.fp32_precision = generic

    def get_precision():
        if mixed:
            raise RuntimeError(MIXED)
        return precision

    monkeypatch.setattr(torch, "backends", fake)
    monkeypatch.setattr(torch, "get_float32_matmul_precision", get_precision)


#: (per-backend newer setting, global newer setting, legacy allow_tf32,
#: legacy precision) -> None to pass, or the setting the refusal names.
TABLE = {
    "defaults": (("none", "none", False, "highest"), None),
    "no_newer_api": ((None, None, False, "highest"), None),
    "matmul_tf32": (("tf32", "none", False, "highest"),
                    "torch.backends.cuda.matmul.fp32_precision"),
    "global_tf32": (("none", "tf32", False, "highest"),
                    "torch.backends.fp32_precision"),
    "global_bf16": (("none", "bf16", False, "highest"),
                    "torch.backends.fp32_precision"),
    "matmul_ieee_over_global_tf32": (("ieee", "tf32", False, "highest"),
                                     None),
    "matmul_ieee": (("ieee", "none", False, "highest"), None),
    "global_ieee": (("none", "ieee", False, "highest"), None),
    "matmul_tf32_over_global_ieee": (
        ("tf32", "ieee", False, "highest"),
        "torch.backends.cuda.matmul.fp32_precision"),
    "legacy_allow_tf32": (("none", "none", True, "high"),
                          "torch.backends.cuda.matmul.allow_tf32"),
    "legacy_high": (("none", "none", False, "high"),
                    "torch.get_float32_matmul_precision"),
    "legacy_medium": (("none", "none", False, "medium"),
                      "torch.get_float32_matmul_precision"),
    "legacy_only_allow_tf32": ((None, None, True, "high"),
                               "torch.backends.cuda.matmul.allow_tf32"),
}


@pytest.mark.parametrize("case", sorted(TABLE))
def test_the_decision_over_torch_settings(case, monkeypatch):
    settings, refusal = TABLE[case]
    _backends(*settings, monkeypatch=monkeypatch)
    if refusal is None:
        _kernels.require_full_fp32("cuda")
        _kernels.require_full_fp32(torch.device("cuda", 0))
    else:
        with pytest.raises(_kernels.KernelError, match=refusal.replace(
                ".", r"\.")):
            _kernels.require_full_fp32("cuda:0")
    _kernels.require_full_fp32("cpu")        # never a refusal on the CPU


def test_the_cpu_is_never_refused(monkeypatch):
    _backends("tf32", "tf32", True, "medium", monkeypatch=monkeypatch)
    _kernels.require_full_fp32("cpu")
    _kernels.require_full_fp32(torch.device("cpu"))


def test_the_real_settings_pass():
    """This process's torch keeps its defaults: full float32."""
    _kernels.require_full_fp32("cuda")


# --- every device function with float products calls the check ------------


def _drive_all():
    """Each path of the port with float products once, on the CPU."""
    import chip_smoke
    from ohpipeline_tpu_torch import bench_secondary as bs
    from ohpipeline_tpu_torch import parallel
    from ohpipeline_tpu_torch.codecs.mp3 import decode_mp3
    from ohpipeline_tpu_torch.codecs.opus import celt
    from ohpipeline_tpu_torch.codecs.vorbis import device as vorbis_device

    lc = (ASSETS / "dryrun.aac").read_bytes()
    he = (ASSETS / "dryrun_he.aac").read_bytes()
    aac_serving.decode_aac_streams_device([lc], device="cpu")
    aac_serving.decode_he_streams_device([he], device="cpu")
    aac.decode_adts(lc, device="cpu")                    # filterbank_fast
    aac.decode_adts(he, device="cpu")                    # core_imdct_device
    bs._codec_decode(lambda: aac.CodecAacAdts(use_native=False,
                                              device="cpu"), lc)
    chip_smoke.serve_ps([chip_smoke.ps_content(0, 8)], "cpu")
    celt.decode_celt_streams_device([(ASSETS / "dryrun.opus").read_bytes()],
                                    device="cpu")
    tone = _host.mp3_encoder.tone_spectrum(30)
    mp3 = _host.mp3_encoder.build_stream([tone, tone], nframes=4)
    mp3_serving.decode_mp3_streams_device([mp3], 4, device="cpu")
    decode_mp3(mp3, device="cpu")
    vorbis_device.decode_vorbis_stream_device(bs.vorbis_stream(0, 0.1),
                                              device="cpu")
    step = parallel.sharded_pipeline_step(
        parallel.make_mesh(devices=["cpu"] * 2))
    rng = np.random.default_rng(3)
    step(*parallel.example_step_args(nframes=2, n=1024),
         rng.standard_normal((2, 2, 1024)).astype(np.float32),
         np.zeros((2, 2), np.int32), np.zeros((2, 1024), np.float32),
         rng.standard_normal((2, 1024)).astype(np.float32))


@pytest.fixture(scope="module")
def callers():
    """(module, function) of every call of require_full_fp32 while the
    paths run, with the device each passed."""
    seen = {}
    real = _kernels.require_full_fp32

    def record(device):
        frame = sys._getframe(1)
        where = (frame.f_globals["__name__"].removeprefix(
            "ohpipeline_tpu_torch."), frame.f_code.co_name)
        seen.setdefault(where, set()).add(torch.device(device).type)
        return real(device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "require_full_fp32", record)
        _drive_all()
    return seen


#: (module under ohpipeline_tpu_torch, function)
CHECKED = [
    ("codecs.aac.synthesis", "decode_chunk_zz"),
    ("codecs.aac.synthesis", "filterbank_fast"),
    ("codecs.aac.synthesis", "filterbank"),
    ("codecs.aac.sbr", "device_decode_qmf"),
    ("codecs.aac.sbr", "device_decode_group"),
    ("codecs.aac.sbr", "core_imdct_device"),
    ("codecs.aac.sbr", "device_decode_group_ps"),
    ("codecs.aac.sbr", "envelope_inputs"),
    ("codecs.aac.sbr", "noise_sine_planes"),
    ("codecs.aac.sbr", "synthesize_slots"),
    ("codecs.aac.sbr", "ps_hybrid_analysis"),
    ("codecs.opus.celt", "device_decode_group"),
    ("codecs.opus.celt", "tdac"),
    ("codecs.opus.celt", "deemphasis"),
    ("codecs.mp3.synthesis", "hybrid_synthesis_parallel"),
    ("codecs.mp3.synthesis", "hybrid_synthesis_parallel_i16"),
    ("codecs.mp3.synthesis", "imdct_overlap"),
    ("codecs.mp3.synthesis", "matrixing"),
    ("codecs.vorbis.device", "group_step"),
    ("parallel", "step"),
]


@pytest.mark.parametrize("where", CHECKED, ids=lambda w: ".".join(w))
def test_each_device_function_checks_the_precision(callers, where):
    assert callers.get(where) == {"cpu"}, sorted(callers)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _serving_calls_refuse():
    lc = (ASSETS / "dryrun.aac").read_bytes()
    tone = _host.mp3_encoder.tone_spectrum(30)
    mp3 = _host.mp3_encoder.build_stream([tone, tone], nframes=4)
    with pytest.raises(_kernels.KernelError, match="float32"):
        aac_serving.decode_aac_streams_device([lc], device="cuda")
    with pytest.raises(_kernels.KernelError, match="float32"):
        mp3_serving.decode_mp3_streams_device([mp3], 4, device="cuda")


@pytest.mark.gpu
def test_tf32_through_the_newer_api_is_refused_on_the_card(cuda):
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    try:
        matmul.fp32_precision = "tf32"
        _serving_calls_refuse()
    finally:
        matmul.fp32_precision = before
    _kernels.require_full_fp32(cuda)


@pytest.mark.gpu
def test_tf32_through_the_legacy_flag_is_refused_on_the_card(cuda):
    matmul = torch.backends.cuda.matmul
    try:
        matmul.allow_tf32 = True
        _serving_calls_refuse()
    finally:
        matmul.allow_tf32 = False
    _kernels.require_full_fp32(cuda)
    lc = (ASSETS / "dryrun.aac").read_bytes()
    pcm, = aac_serving.decode_aac_streams_device([lc], device="cuda")
    assert np.asarray(pcm).any()
