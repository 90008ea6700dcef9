"""The port stands alone: it decodes FLAC, AAC-LC, HE-AAC v1 (serving, and the
ADTS codec plug-in), HE-AAC v2 groups (the parametric-stereo runner), CELT,
MP3 and Vorbis, runs the flagship step, plays FLAC, MP3, M4A, ALAC and
SILK files through its pipeline, serves FLAC over a mesh (``mesh=``),
fans a branch out to its devices (``IciBranch``), plays a tone through
its MediaPlayer's Playlist source at volume 50, takes OHM audio from a
Songcast sender on loopback into a SourceReceiver and writes a tone's WAV
through its player entry point, and runs its headline bench's smoke run,
with every import of jax and of ohpipeline_tpu failing, in
the repository and in a directory that holds only the port, chip_smoke.py and
the test assets, each of those paths a stage in a process of its own (a
failure names its stage); no module of ohpipeline_tpu is ever loaded; its HE path
parses every SBR payload natively; its copies of the JAX package's .cc,
.npz and whole .py files are byte for byte the originals; no file of the
port imports jax or the JAX package or builds a path into it.  Its chip
smoke test refuses to run, and builds nothing, where there is no CUDA
device."""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "ohpipeline_tpu_torch"

#: Run first in every stage: jax and the JAX package blocked, the Python
#: SBR parser, CELT entropy layer and Huffman and residue walks made to
#: raise, and the FLAC and MP3 content the stages share (``rng`` left where
#: the MP3 draws end, for the Vorbis residues).
_PRELUDE = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["ohpipeline_tpu"] = None   # and of the JAX package
import numpy as np
from ohpipeline_tpu_torch import _host
from ohpipeline_tpu_torch.host.codecs.mp3 import bitstream
from ohpipeline_tpu_torch.host.codecs.vorbis import residue


def python_sbr_parser(*args, **kwargs):
    raise AssertionError("the Python SBR bit parser was taken")


def python_entropy(*args, **kwargs):
    raise AssertionError("the Python CELT entropy layer was taken")


def python_walk(*args, **kwargs):
    raise AssertionError("a Python Huffman or residue walk was taken")


_host.aac_sbr.parse_sbr_data = python_sbr_parser
_host.celt._entropy_decode_py = python_entropy
bitstream.parse_huffman_py = residue._decode_vectors = python_walk

t = np.arange(5000) / 44100.0
x = np.stack([np.rint(9000 * np.sin(2 * np.pi * 440 * t)),
              np.rint(7000 * np.sin(2 * np.pi * 660 * t))])
x = x.astype(np.int32)
data = _host.encode_flac(x, 44100, 16, blocksize=1024)
rng = np.random.default_rng(3)
spec = np.where(rng.random((2, 576)) < 0.2, rng.integers(-9, 10, (2, 576)),
                0)
mp3 = _host.mp3_encoder.build_stream([spec[0], spec[1]], nframes=5,
                                     global_gain=180)
"""

#: Run last in every stage: no module of the JAX package was loaded.
_EPILOGUE = """
loaded = [m for m in sys.modules if m == "ohpipeline_tpu"
          or m.startswith("ohpipeline_tpu.")]
assert loaded == ["ohpipeline_tpu"], loaded     # the blocking None
assert sys.modules["ohpipeline_tpu"] is None
print("port ok without jax")
"""

#: The port's paths, each run in a process of its own after the prelude.
STAGES = {
    "serving": """
from ohpipeline_tpu_torch.codecs.aac.serving import decode_aac_streams_device
from ohpipeline_tpu_torch.codecs.flac.serving import (
    decode_flac_streams_device)
from ohpipeline_tpu_torch.entry import entry

out, = decode_flac_streams_device([data], frames_per_group=8, device="cpu")
assert (out == x).all()
fn, args = entry("cpu")
fn(*args)
aac = open("tests/assets/dryrun.aac", "rb").read()
pcm, = decode_aac_streams_device([aac], 64, device="cpu")
assert pcm.shape == (2, 89 * 1024) and pcm.any()
""",
    "codecs": """
from ohpipeline_tpu_torch.codecs import aac
from ohpipeline_tpu_torch.codecs.aac.serving import decode_he_streams_device
from ohpipeline_tpu_torch.codecs.mp3.serving import decode_mp3_streams_device
from ohpipeline_tpu_torch.codecs.opus.celt import decode_celt_streams_device
from ohpipeline_tpu_torch.codecs.vorbis.device import (
    decode_vorbis_stream_device)

he = open("tests/assets/dryrun_he.aac", "rb").read()
pcm, = decode_he_streams_device([he], 48, device="cpu")
assert pcm.shape == (2, 46 * 2048) and pcm.any()
info, pcm = aac.decode_adts(he, device="cpu")
assert info.codec_name == "HE-AAC" and pcm.shape == (2, 46 * 2048)
opus = open("tests/assets/dryrun.opus", "rb").read()
pcm, = decode_celt_streams_device([opus], 32, device="cpu")
assert pcm.shape == (2, 50 * 960) and pcm.any()
pcm, = decode_mp3_streams_device([mp3], 4, device="cpu")
assert pcm.shape == (2, 5 * 1152) and pcm.any()
vs = _host.vorbis_encoder.StreamSpec(channels=2, sample_rate=44100,
                                     bs0=256, bs1=1024, coupling=True)
res = np.where(rng.random((2, 512)) < 0.3, rng.integers(-2, 3, (2, 512)), 0)
ogg = vs.build([(1, [(140, 120)] * 2, res)] * 6)
pcm = decode_vorbis_stream_device(ogg, 4, device="cpu")
assert pcm.shape == (2, 5 * 512) and pcm.any()
""",
    "ps_runner": """
import chip_smoke
from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd

c = chip_smoke.ps_content(0, 8)
runner = sbrd.SbrPsDeviceRunner(c["dec"], device="cpu")
pcm = runner.decode_group_lazy_spec(
    c["specs"], c["ops"], c["datas"], c["Es"], c["Qs"], c["ps"],
    np.zeros(1024, np.float32))()
assert pcm.shape == (2, 8 * 2048) and pcm.any()
""",
    "render": """
import tempfile

import chip_smoke

with tempfile.TemporaryDirectory() as tmp:
    path = tmp + "/t.flac"
    with open(path, "wb") as f:
        f.write(data)
    sink, _wall, _batcher = chip_smoke.render_play(path, "cpu")
    assert sink.infos[0].codec_name == "FLAC" and (sink.pcm == x).all()
    alac, alac_pcm = chip_smoke.alac_escape_stream(0, 0.3)
    for name, content in (
            ("MP3", mp3), ("AAC", chip_smoke.m4a_from_adts(
                "tests/assets/dryrun.aac")),
            ("Opus", chip_smoke.opus_ogg(chip_smoke.silk_packets(0, 6))),
            ("ALAC", alac)):
        with open(path, "wb") as f:
            f.write(content)
        sink, _wall, _batcher = chip_smoke.render_play(path, "cpu")
        assert sink.infos[0].codec_name == name and sink.pcm.any(), name
    assert (sink.pcm == alac_pcm).all()
""",
    "mesh": """
from ohpipeline_tpu_torch import parallel
from ohpipeline_tpu_torch.codecs.flac.serving import (
    decode_flac_streams_device)
from ohpipeline_tpu_torch.host.core import events as ev
from ohpipeline_tpu_torch.host.core.streaminfo import PcmStreamInfo
from ohpipeline_tpu_torch.pipeline.branch import IciBranch

mesh = parallel.make_mesh(devices=["cpu"] * 4)
outs = decode_flac_streams_device([data, data, data], frames_per_group=8,
                                  mesh=mesh)
assert len(outs) == 3 and all((o == x).all() for o in outs)
ici = IciBranch(mesh)
info = PcmStreamInfo(sample_rate=44100, bit_depth=16, num_channels=2)
ici.push(ev.AudioPcmEvent(x[:, :1500], info))
ici.push(ev.HaltEvent())
assert ici.tiles_sent == 2 and len(ici.rooms()) == 4
tail = np.zeros((2, IciBranch.TILE), np.float32)
tail[:, :1500 - 1024] = x[:, 1024:1500]
assert all((room == tail).all() for room in ici.rooms())
""",
    "av": """
import chip_smoke
from ohpipeline_tpu_torch import av
from ohpipeline_tpu_torch.host.av import services
from ohpipeline_tpu_torch.host.protocols import playlists


def tone(player):
    track_id = player.source_playlist.db.insert(
        0, "tone://sine.wav?duration=1")
    player.source_playlist.seek_id(track_id)
    return [track_id]


player = chip_smoke.media_player("cpu", volume=50)
sink, _wall, batcher, track_ids, ids, _ = chip_smoke.player_run(player, tone)
assert sink.pcm.shape == (2, 44100) and sink.pcm.any()
assert batcher.gain_tiles > 0 and track_ids == ids == [1]
assert isinstance(player, av.MediaPlayer)
assert playlists.extract_stream_uris(
    b"<opml><body><outline type='audio' URL='http://a/s.mp3'/></body>"
    b"</opml>") == ["http://a/s.mp3"]
assert services.parse_opml
""",
    "songcast": """
import time

import chip_smoke
from ohpipeline_tpu_torch.host.av.receiver_sources import SourceReceiver
from ohpipeline_tpu_torch.host.net.songcast import OhmSender
from ohpipeline_tpu_torch.pipeline import (AnimatorBatch, PipelineInitParams,
                                           PipelineManager)

mgr = PipelineManager(chip_smoke.render_params(PipelineInitParams()),
                      device="cpu")
ohm = OhmSender(multicast=False)
ohm.start()
src = SourceReceiver(mgr, multicast=False,
                     sender_endpoint=("127.0.0.1", ohm.endpoint[1]))
# the receiver counts a frame before it hands the frame's PCM to the
# protocol, so wait for the hand-over itself: the frames the source's
# on_audio has pushed, and the protocol's buffer read to its end
delivered = []
on_audio = src._on_audio


def record(samples, msg):
    on_audio(samples, msg)
    delivered.append((msg.frame, msg.sample_start))


src._on_audio = record
src.set_sender()
src.activate()
deadline = time.monotonic() + 5
while not ohm._listeners and time.monotonic() < deadline:
    time.sleep(0.01)
assert ohm._listeners, "the receiver did not join the sender"
for i in range(16):
    ohm.send_audio(x[:, :1024], 44100, 16, sample_start=1024 * i)
deadline = time.monotonic() + 10
while len(delivered) < 16 or src.protocol._buffer:
    assert time.monotonic() < deadline, ("the OHM audio did not arrive",
                                          delivered)
    time.sleep(0.01)
src.protocol.push_halt()
sink = chip_smoke.Sink()
AnimatorBatch(mgr.pipeline.predriver, sink, device="cpu").run()
src.deactivate()
mgr.quit()
ohm.stop()
nz = sink.pcm.any(axis=0).sum()
assert nz >= 16 * 1000, (int(nz), sink.pcm.shape, delivered)
""",
    "player": """
import os
import tempfile

from ohpipeline_tpu_torch.tools import player as cli

with tempfile.TemporaryDirectory() as tmp:
    assert cli.main(["--cpu", "--uri", "tone://sine.wav?duration=1",
                     "--wav", tmp + "/o.wav"]) == 0
    assert os.path.getsize(tmp + "/o.wav") == 44 + 4 * 44100
""",
    "bench": """
from ohpipeline_tpu_torch import bench

assert bench.main(["--smoke", "--cpu"]) == 0
""",
}


def _script(stage: str) -> str:
    return _PRELUDE + STAGES[stage] + _EPILOGUE


def _run(args, cwd, timeout=300, env=None):
    if env is None:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _run_stage(stage: str, cwd, env=None):
    """Runs ``stage`` with jax and the JAX package blocked; a failure names
    the stage and shows the end of its output."""
    try:
        proc = _run([sys.executable, "-c", _script(stage)], cwd, env=env)
    except subprocess.TimeoutExpired as e:
        err = e.stderr or b""
        if isinstance(err, bytes):
            err = err.decode(errors="replace")
        pytest.fail(f"stage {stage} ran out of its {e.timeout} s:\n"
                    f"{err[-3000:]}")
    assert proc.returncode == 0, f"stage {stage}:\n{proc.stderr[-3000:]}"
    assert "port ok without jax" in proc.stdout


@pytest.mark.parametrize("stage", STAGES)
def test_port_imports_and_decodes_with_jax_blocked(stage):
    _run_stage(stage, REPO)


@pytest.mark.parametrize("stage", STAGES)
def test_port_runs_from_a_directory_without_the_jax_package(stage, tmp_path):
    shutil.copytree(PORT, tmp_path / PORT.name,
                    ignore=shutil.ignore_patterns("__pycache__", "*.tmp"))
    shutil.copytree(REPO / "tests" / "assets", tmp_path / "tests" / "assets")
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    assert not (tmp_path / "ohpipeline_tpu").exists()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    _run_stage(stage, tmp_path, env=env)


def _copies():
    host = PORT / "host"
    return sorted(p for p in host.rglob("*") if p.suffix in (".cc", ".npz"))


def test_copied_sources_and_tables_are_the_originals():
    copies = _copies()
    assert {str(p.relative_to(PORT / "host")) for p in copies} == {
        "native/flac_unpack.cc", "native/aac_unpack.cc",
        "native/sbr_parse.cc", "native/celt_core.cc", "native/mp3_core.cc",
        "native/vorbis_core.cc", "native/silk_core.cc",
        "native/silk_parse.cc", "native/silk_synth.cc",
        "native/alac_core.cc", "codecs/aac/tables.npz",
        "codecs/aac/sbr_tables.npz", "codecs/opus/celt_mode.npz",
        "codecs/opus/silk_tables.npz", "codecs/mp3/tables.npz",
        "codecs/vorbis/tables.npz"}
    for p in copies:
        original = REPO / "ohpipeline_tpu" / p.relative_to(PORT / "host")
        assert p.read_bytes() == original.read_bytes(), p


#: Host files the port copies whole (its other .py copies are in part).
PY_COPIES = (
    "core/__init__.py", "core/jiffies.py", "core/streaminfo.py",
    "core/events.py", "core/ramp.py",
    "codecs/base.py", "codecs/wav.py", "codecs/aiff.py", "codecs/pcm_raw.py",
    "codecs/dsd.py", "codecs/opus/__init__.py", "codecs/vorbis/__init__.py",
    "containers/__init__.py", "containers/base.py", "containers/id3v2.py",
    "containers/mpegts.py", "containers/mpeg4.py",
    "protocols/__init__.py", "protocols/base.py", "protocols/file.py",
    "protocols/tone.py", "protocols/hls.py", "protocols/dash.py",
    "protocols/rtsp.py",
    "pipeline/elements.py", "pipeline/control.py", "pipeline/reservoirs.py",
    "pipeline/supply.py", "pipeline/filler.py", "pipeline/starvation.py",
    "pipeline/latency.py", "pipeline/observer.py",
    "protocols/playlists.py",
    "av/config.py", "av/power.py", "av/product.py", "av/misc.py",
    "av/ops_support.py", "av/volume.py", "av/sources.py",
    "av/credentials.py", "av/oauth.py", "av/pins.py", "av/podcasts.py",
    "av/reactions.py", "av/sender.py", "av/services.py", "av/raat.py",
    "av/receiver_sources.py",
    "net/__init__.py", "net/odp.py", "net/songcast.py", "net/scd.py",
    "net/ntp.py", "net/mdns.py", "net/artwork.py", "net/shell.py",
    "net/webapp.py", "net/raop.py", "net/upnp.py", "net/providers.py")

#: The net layer's static web resources, byte copies beside the copy of
#: webapp.py (it finds them through its own path).
WEBUI_COPIES = ("net/webui/config/index.html", "net/webui/config/config.js",
                "net/webui/config/en-gb/ConfigOptions.txt")


@pytest.mark.parametrize("rel", PY_COPIES)
def test_whole_python_copies_are_the_originals(rel):
    copy = PORT / "host" / rel
    assert copy.read_bytes() == (REPO / "ohpipeline_tpu" / rel).read_bytes()


@pytest.mark.parametrize("rel", WEBUI_COPIES)
def test_web_resources_are_the_originals(rel):
    copy = PORT / "host" / rel
    assert copy.read_bytes() == (REPO / "ohpipeline_tpu" / rel).read_bytes()


def test_the_web_resources_are_all_copied():
    def tree(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file())

    assert tree(REPO / "ohpipeline_tpu" / "net" / "webui") \
        == tree(PORT / "host" / "net" / "webui") \
        == sorted(rel[len("net/webui/"):] for rel in WEBUI_COPIES)


_JAX_TEXT = re.compile(r"\b(import\s+jax|from\s+jax)\b")
_INTO_JAX_PKG = re.compile(r"(^|[/\\])ohpipeline_tpu([/\\]|$)")
_FILE_LINE = re.compile(r"^ohpipeline_tpu/[\w/]+\.py:\d+(-\d+)?$")


def _docstrings(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) \
                    and isinstance(first.value, ast.Constant):
                out.add(id(first.value))
    return out


def _faults(path: pathlib.Path) -> list:
    text = path.read_text()
    faults = [f"text {m.group(0)!r}" for m in _JAX_TEXT.finditer(text)]
    tree = ast.parse(text)
    docs = _docstrings(tree)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            if name.split(".")[0] in ("jax", "jaxlib", "ohpipeline_tpu"):
                faults.append(f"line {node.lineno}: imports {name}")
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs \
                and _INTO_JAX_PKG.search(node.value) \
                and not _FILE_LINE.match(node.value):
            faults.append(f"line {node.lineno}: path {node.value!r}")
    return faults


@pytest.mark.parametrize("rel", sorted(
    str(p.relative_to(REPO)) for p in [*PORT.rglob("*.py"),
                                        REPO / "chip_smoke.py"]
    if "_build" not in p.parts))
def test_no_file_of_the_port_reaches_jax_or_the_jax_package(rel):
    assert _faults(REPO / rel) == []


def test_the_static_check_sees_what_it_should(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text('"""doc: ohpipeline_tpu/native"""\n'
                   "def f():\n"
                   "    import jax.numpy as jnp\n"
                   "    from ohpipeline_tpu import native\n"
                   "    p = 'ohpipeline_tpu/codecs'\n"
                   "    q = 'ohpipeline_tpu/ops/lpc.py:131'\n")
    faults = _faults(bad)
    assert len(faults) == 4, faults       # text, two imports, one path
    # the JAX files the render path's copies come from carry JAX text; the
    # port's copy of one and its own animators do not
    for rel in ("pipeline/branch.py", "pipeline/animator.py"):
        assert _faults(REPO / "ohpipeline_tpu" / rel), rel
    assert not _faults(PORT / "host" / "pipeline" / "branch.py")
    assert not _faults(PORT / "pipeline" / "animator.py")


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    build = REPO / "ohpipeline_tpu_torch" / "_build"

    def kernels():          # the C++ parsers of other tests build here too
        return sorted([*build.glob("libohp_kernels*"), *build.glob("*.o")])

    before = kernels()
    proc = _run([sys.executable, "chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout
    assert kernels() == before, "chip_smoke.py built something without a card"


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
