"""The port runs where JAX is absent (it decodes FLAC, AAC-LC and HE-AAC v1
and runs the flagship step with every import of jax failing, and imports no
module of ohpipeline_tpu.codecs, .ops or .parallel; its HE path parses every
SBR payload natively), and its chip smoke test refuses to run, and builds
nothing, where there is no CUDA device."""

import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_JAX = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any import of jax now fails
    import numpy as np
    from ohpipeline_tpu_torch import _host
    from ohpipeline_tpu_torch.codecs.aac.serving import (
        decode_aac_streams_device, decode_he_streams_device)
    from ohpipeline_tpu_torch.codecs.flac.serving import (
        decode_flac_streams_device)
    from ohpipeline_tpu_torch.entry import entry

    t = np.arange(5000) / 44100.0
    x = np.stack([np.rint(9000 * np.sin(2 * np.pi * 440 * t)),
                  np.rint(7000 * np.sin(2 * np.pi * 660 * t))])
    x = x.astype(np.int32)
    data = _host.encode_flac(x, 44100, 16, blocksize=1024)
    out, = decode_flac_streams_device([data], frames_per_group=8,
                                      device="cpu")
    assert (out == x).all()
    fn, args = entry("cpu")
    fn(*args)
    aac = open("tests/assets/dryrun.aac", "rb").read()
    pcm, = decode_aac_streams_device([aac], 64, device="cpu")
    assert pcm.shape == (2, 89 * 1024) and pcm.any()

    def python_sbr_parser(*args, **kwargs):
        raise AssertionError("the Python SBR bit parser was taken")

    _host.aac_sbr.parse_sbr_data = python_sbr_parser
    he = open("tests/assets/dryrun_he.aac", "rb").read()
    pcm, = decode_he_streams_device([he], 48, device="cpu")
    assert pcm.shape == (2, 46 * 2048) and pcm.any()
    assert not any(m == "ohpipeline_tpu.codecs" or m.startswith(
        ("ohpipeline_tpu.codecs.", "ohpipeline_tpu.ops",
         "ohpipeline_tpu.parallel")) for m in sys.modules)
    print("port ok without jax")
""")


def _run(args, cwd, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_and_decodes_with_jax_blocked():
    proc = _run([sys.executable, "-c", _BLOCKED_JAX], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "port ok without jax" in proc.stdout


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    build = REPO / "ohpipeline_tpu_torch" / "_build"
    before = sorted(build.glob("*")) if build.exists() else None
    proc = _run([sys.executable, "chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout
    after = sorted(build.glob("*")) if build.exists() else None
    assert after == before, "chip_smoke.py built something without a card"


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
