"""The JAX package's tests of the Av layer and of the playlist parser, run
against the port's copies.

Each JAX test file below is read as it stands, its imports of the JAX
package are pointed into the port, and its cases are collected here, each
as its own test (``Test_<file>__<class>`` / ``test_<file>__<function>``).
An import of ``ohpipeline_tpu.X`` resolves to the port's public module where
the port has one with a device (``av``, ``av.media_player``, ``pipeline``,
``codecs``) and to its host copy ``ohpipeline_tpu_torch.host.X`` otherwise.
The device classes the cases build come with the CPU as their device:
``MediaPlayer`` and ``PipelineManager`` default to ``device="cpu"``,
``AnimatorBatch`` takes the JAX one's ``use_device`` (the CPU either way
here), and ``codecs.default_registry`` is the registry of the CPU.

The net layer (``ohpipeline_tpu.net``) is not ported yet: the cases of
:data:`WAIT_FOR_NET` reach it, and each of them is held to raise
``ModuleNotFoundError`` for a module of ``ohpipeline_tpu_torch.host.net``.
A module-level import of the net layer binds a stand-in that raises that
error when the case uses it, so the file's other cases still run.  When the
net layer arrives, such a case fails until it leaves the list.
"""

import ast
import functools
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

#: Cases that reach the net layer (file, class or None, function).
WAIT_FOR_NET = {
    ("test_av_misc.py", "TestArtwork", "test_serve_and_observe"),
    ("test_av_services.py", "TestOAuthProvider",
     "test_set_token_encrypted_wire"),
    ("test_av_services.py", "TestOAuthProvider", "test_error_codes"),
    ("test_av_services.py", "TestOAuthProvider", "test_clears_and_selection"),
    ("test_av_services.py", "TestOAuthProvider",
     "test_limited_input_flow_job"),
    ("test_ops_support.py", "TestOhz", "test_wire_roundtrip"),
    ("test_ops_support.py", "TestOhz", "test_discovery_loopback"),
    ("test_pins_service.py", "TestOdpPinsService",
     "test_full_surface_and_error_codes"),
    ("test_pins_service.py", "TestOdpPinsService", "test_id_array_evented"),
    ("test_receiver_sources.py", "TestSongcastSource",
     "test_ohm_loopback_to_pipeline"),
    ("test_receiver_sources.py", "TestScdSource", "test_scd_loopback"),
    ("test_reactions.py", None, "test_odp_reaction_service"),
    ("test_volume_monkey.py", None, "test_odp_volume_full_surface"),
    ("test_volume_monkey.py", None, "test_odp_volume_offsets_not_supported"),
    ("test_volume_monkey.py", None, "test_odp_time_and_credentials_services"),
    ("test_volume_monkey.py", None, "test_odp_volume_error_codes"),
}

JAX_PKG = "ohpipeline_tpu"
PORT_PKG = "ohpipeline_tpu_torch"
NET = f"{PORT_PKG}.host.net"
#: JAX modules whose port counterpart is the port's public module.
PUBLIC = {"av", "av.media_player", "pipeline", "codecs"}


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


def cpu_default(obj):
    """``obj`` as a case of the JAX tests gets it on a box without a card."""
    if obj is port_media_player.MediaPlayer:
        return MediaPlayer
    if obj is port_pipeline.PipelineManager:
        return PipelineManager
    if obj is port_pipeline.AnimatorBatch:
        return AnimatorBatch
    if obj is port_codecs.default_registry:
        return port_codecs.default_registry("cpu")
    return obj


class Missing:
    """Stands in for a module-level import that failed: any use raises the
    import's error again."""

    def __init__(self, error: ModuleNotFoundError):
        self._error = error

    def _raise(self):
        raise ModuleNotFoundError(str(self._error), name=self._error.name)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        self._raise()

    def __call__(self, *args, **kwargs):
        self._raise()


def resolve(module: str, name: str, lazy: bool):
    """The port's object for ``from module import name``, ``module`` a
    module of the JAX package; with ``lazy``, a :class:`Missing` where the
    net layer is missing."""
    try:
        mod = importlib.import_module(port_module(module))
        if hasattr(mod, name):
            return cpu_default(getattr(mod, name))
        return importlib.import_module(port_module(f"{module}.{name}"))
    except ModuleNotFoundError as e:
        if lazy and (e.name or "").startswith(NET):
            return Missing(e)
        raise


class PortImports(ast.NodeTransformer):
    """Turns each import of the JAX package into assignments from
    :func:`resolve`; a module-level one may bind :class:`Missing`."""

    def __init__(self):
        self.depth = 0

    def _nested(self, node):
        self.depth += 1
        self.generic_visit(node)
        self.depth -= 1
        return node

    visit_FunctionDef = visit_AsyncFunctionDef = _nested

    def _assign(self, node, target: str, module: str, name):
        call = ast.Call(
            func=ast.Name("__port_import__", ast.Load()),
            args=[ast.Constant(module), ast.Constant(name),
                  ast.Constant(self.depth == 0)], keywords=[])
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
        for a in node.names:
            if a.name.split(".")[0] == JAX_PKG:
                raise NotImplementedError(f"import {a.name}: only 'from' "
                                          f"imports are pointed at the port")
        return node


def load(filename: str) -> types.ModuleType:
    """The JAX test file ``filename``, run with its imports in the port."""
    path = TESTS / filename
    tree = PortImports().visit(ast.parse(path.read_text(), str(path)))
    ast.fix_missing_locations(tree)
    mod = types.ModuleType(f"jax_cases_{path.stem}")
    mod.__file__ = str(path)
    mod.__dict__["__port_import__"] = resolve
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


def waits_for_net(fn):
    """The case ``fn``, held to reach the missing net layer."""

    @functools.wraps(fn)
    def case(*args, **kwargs):
        with pytest.raises(ModuleNotFoundError) as info:
            fn(*args, **kwargs)
        assert (info.value.name or "").startswith(NET), info.value

    return case


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
                    if (filename, name, attr) in WAIT_FOR_NET:
                        setattr(obj, attr, waits_for_net(fn))
            namespace[f"Test_{stem}__{name}"] = obj
        elif inspect.isfunction(obj) and name.startswith("test_"):
            cases.append((None, name))
            if (filename, None, name) in WAIT_FOR_NET:
                obj = waits_for_net(obj)
            namespace[f"test_{stem}__{name}"] = obj
        elif getfixturemarker(obj) is not None:
            assert name not in namespace, f"fixture {name} defined twice"
            namespace[name] = obj
    return [(filename, c, f) for c, f in cases]


CASES = [case for f in JAX_FILES for case in collect(f, globals())]


def test_every_case_waiting_for_the_net_layer_exists():
    assert WAIT_FOR_NET <= set(CASES)
    assert len(CASES) - len(WAIT_FOR_NET) >= 90
