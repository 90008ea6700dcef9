"""The JAX package's tests of the Av layer and of the playlist parser, run
against the port's copies.

Each JAX test file below is read as it stands, its imports of the JAX
package are pointed into the port, and its cases are collected here, each
as its own test (``Test_<file>__<class>`` / ``test_<file>__<function>``).
An import of ``ohpipeline_tpu.X`` resolves to the port's public module where
the port has one with a device (``av``, ``av.media_player``, ``pipeline``,
``pipeline.animator``, ``codecs``) and to its host copy
``ohpipeline_tpu_torch.host.X`` otherwise.  The device classes the cases
build come with the CPU as their device: ``MediaPlayer`` and
``PipelineManager`` default to ``device="cpu"``, ``AnimatorBatch`` and
``AnimatorSongcastSender`` take the JAX ones' ``use_device`` (the CPU either
way here), and ``codecs.default_registry`` is the registry of the CPU.  A
file's module-level fixtures are renamed ``<file>__<name>`` throughout that
file, so files whose fixtures share a name (``media_player``) can be
collected into one module.  ``test_torch_net.py`` collects the net layer's
tests with the same loader.
"""

import ast
import importlib
import inspect
import pathlib
import types

import pytest
from _pytest.fixtures import getfixturemarker

from ohpipeline_tpu_torch import codecs as port_codecs
from ohpipeline_tpu_torch import pipeline as port_pipeline
from ohpipeline_tpu_torch.av import media_player as port_media_player

TESTS = pathlib.Path(__file__).resolve().parent

#: The JAX test files run here: every case of the Av layer's tests, and the
#: HLS and playlist-content cases of test_protocols_hls.py.
JAX_FILES = (
    "test_av.py", "test_av_misc.py", "test_av_services.py",
    "test_ops_support.py", "test_pins_service.py", "test_podcasts.py",
    "test_raat_source.py", "test_receiver_sources.py", "test_reactions.py",
    "test_service_catalogue.py", "test_volume_monkey.py",
    "test_protocols_hls.py")

JAX_PKG = "ohpipeline_tpu"
PORT_PKG = "ohpipeline_tpu_torch"
#: JAX modules whose port counterpart is the port's public module.
PUBLIC = {"av", "av.media_player", "pipeline", "pipeline.animator",
          "codecs"}


def port_module(name: str) -> str:
    """The port's module for the JAX package's module ``name``."""
    rest = name[len(JAX_PKG) + 1:]
    if rest in PUBLIC:
        return f"{PORT_PKG}.{rest}"
    return f"{PORT_PKG}.host.{rest}"


class MediaPlayer(port_media_player.MediaPlayer):
    """The port's MediaPlayer, on the CPU unless told otherwise."""

    def __init__(self, params=None, *, device="cpu"):
        super().__init__(params, device=device)


class PipelineManager(port_pipeline.PipelineManager):
    """The port's PipelineManager, on the CPU unless told otherwise."""

    def __init__(self, params=None, *, device="cpu", **kwargs):
        super().__init__(params, device=device, **kwargs)


class AnimatorBatch(port_pipeline.AnimatorBatch):
    """The port's AnimatorBatch, taking the JAX one's ``use_device``: the
    gain pass runs on the CPU either way here."""

    def __init__(self, pipeline, sink, use_device=True, device="cpu"):
        super().__init__(pipeline, sink, device=device)


class AnimatorSongcastSender(port_pipeline.AnimatorSongcastSender):
    """The port's AnimatorSongcastSender, taking the JAX one's
    ``use_device``: the gain pass runs on the CPU either way here."""

    def __init__(self, pipeline, ohm_sender, quantum_ms=5, use_device=False,
                 realtime=True, device="cpu"):
        super().__init__(pipeline, ohm_sender, quantum_ms=quantum_ms,
                         device=device, realtime=realtime)


def cpu_default(obj):
    """``obj`` as a case of the JAX tests gets it on a box without a card."""
    if obj is port_media_player.MediaPlayer:
        return MediaPlayer
    if obj is port_pipeline.PipelineManager:
        return PipelineManager
    if obj is port_pipeline.AnimatorBatch:
        return AnimatorBatch
    if obj is port_pipeline.AnimatorSongcastSender:
        return AnimatorSongcastSender
    if obj is port_codecs.default_registry:
        return port_codecs.default_registry("cpu")
    return obj


def resolve(module: str, name: str):
    """The port's object for ``from module import name``, ``module`` a
    module of the JAX package."""
    mod = importlib.import_module(port_module(module))
    if hasattr(mod, name):
        return cpu_default(getattr(mod, name))
    return importlib.import_module(port_module(f"{module}.{name}"))


class PortImports(ast.NodeTransformer):
    """Turns each import of the JAX package into assignments from
    :func:`resolve`."""

    def _assign(self, node, target: str, module: str, name):
        call = ast.Call(
            func=ast.Name("__port_import__", ast.Load()),
            args=[ast.Constant(module), ast.Constant(name)], keywords=[])
        return ast.copy_location(
            ast.Assign(targets=[ast.Name(target, ast.Store())], value=call),
            node)

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if node.level or mod.split(".")[0] != JAX_PKG:
            return node
        return [self._assign(node, a.asname or a.name, mod, a.name)
                for a in node.names]

    def visit_Import(self, node):
        """``import ohpipeline_tpu.a.b as x`` is read as ``from
        ohpipeline_tpu.a import b as x``."""
        if not any(a.name.split(".")[0] == JAX_PKG for a in node.names):
            return node
        out = []
        for a in node.names:
            module, _, name = a.name.rpartition(".")
            if not a.asname or module.split(".")[0] != JAX_PKG:
                raise NotImplementedError(f"import {a.name}: only 'from' "
                                          f"and 'as' imports are pointed at "
                                          f"the port")
            out.append(self._assign(node, a.asname, module, name))
        return out


def is_fixture(node) -> bool:
    """Whether the module-level ``def`` ``node`` is a pytest fixture."""
    for d in node.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        if isinstance(d, ast.Attribute) and d.attr == "fixture" \
                and isinstance(d.value, ast.Name) and d.value.id == "pytest":
            return True
    return False


class RenameFixtures(ast.NodeTransformer):
    """Renames the module-level fixtures of a file, and every name and
    parameter that refers to them, ``<prefix>__<name>``."""

    def __init__(self, tree, prefix: str):
        self.names = {n.name: f"{prefix}__{n.name}" for n in tree.body
                      if isinstance(n, ast.FunctionDef) and is_fixture(n)}

    def visit_FunctionDef(self, node):
        node.name = self.names.get(node.name, node.name)
        return self.generic_visit(node)

    def visit_arg(self, node):
        node.arg = self.names.get(node.arg, node.arg)
        return node

    def visit_Name(self, node):
        node.id = self.names.get(node.id, node.id)
        return node


def load(filename: str) -> types.ModuleType:
    """The JAX test file ``filename``, run with its imports in the port and
    its fixtures renamed."""
    path = TESTS / filename
    tree = ast.parse(path.read_text(), str(path))
    tree = RenameFixtures(tree, path.stem[len("test_"):]).visit(tree)
    tree = PortImports().visit(tree)
    ast.fix_missing_locations(tree)
    mod = types.ModuleType(f"jax_cases_{path.stem}")
    mod.__file__ = str(path)
    mod.__dict__["__port_import__"] = resolve
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


def collect(filename: str, namespace: dict) -> list:
    """Puts the cases of ``filename`` (and its module-level fixtures) into
    ``namespace``.  Returns (file, class or None, function) of each case."""
    mod = load(filename)
    stem = filename[len("test_"):-len(".py")]
    cases = []
    for name, obj in list(vars(mod).items()):
        if inspect.isclass(obj) and name.startswith("Test") \
                and obj.__module__ == mod.__name__:
            for attr, fn in list(vars(obj).items()):
                if attr.startswith("test_") and inspect.isfunction(fn):
                    cases.append((name, attr))
            namespace[f"Test_{stem}__{name}"] = obj
        elif inspect.isfunction(obj) and name.startswith("test_"):
            cases.append((None, name))
            namespace[f"test_{stem}__{name}"] = obj
        elif getfixturemarker(obj) is not None:
            assert name not in namespace, f"fixture {name} defined twice"
            namespace[name] = obj
    return [(filename, c, f) for c, f in cases]


CASES = [case for f in JAX_FILES for case in collect(f, globals())]


def test_every_case_waiting_for_the_net_layer_exists():
    """Every case function of the files is collected (115, 117 tests with
    their parameters), the 16 that reached the net layer before it was
    ported among them."""
    assert len(CASES) >= 115
