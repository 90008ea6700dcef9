"""The JAX package's tests of the Av layer and of the playlist parser, run
against the port's copies, and the loader that runs the JAX package's test
files on the port (``test_torch_net.py`` and ``test_torch_jax_*.py`` use it
too).

Each JAX test file is read as it stands, its imports of the JAX package
are pointed into the port, and its cases are collected, each as its own
test (``Test_<file>__<class>`` / ``test_<file>__<function>``), with the
file's own marks (its oracle skips).  A name ``N`` of the JAX module
``ohpipeline_tpu.M`` resolves (:func:`lookup`) to, in order: the port's
module for a JAX submodule ``M.N``; the name in the port's public module
for ``M`` where :data:`PUBLIC` names one (the modules that hold a device:
``av``, ``pipeline``, ``codecs`` and the FLAC, AAC and MP3 plug-ins); the
name in the host copy ``ohpipeline_tpu_torch.host.M``; and a name the JAX
``M`` re-exports from one of its submodules, to that submodule's port
counterpart.  A JAX package or public module becomes a
:class:`ModuleView` (``flac.encode_flac`` looks up as above, and a
monkeypatch of one of its names patches the port's module that holds it);
any other JAX module is its host copy itself.  A class or function of the
port that takes ``device`` gets the loader's device by default (the CPU, or
``cuda`` in ``test_torch_jax_card.py``), the JAX animators' ``use_device``
flag is dropped, and ``codecs.default_registry`` is the registry of that
device.  An import of a sibling JAX test file (``from test_pipeline_e2e
import ...``) takes that file as the loader runs it.  A file's
module-level fixtures are renamed ``<file>__<name>`` throughout that file,
so files whose fixtures share a name (``media_player``) can be collected
into one module.  Each collecting file lists the cases it leaves out, with
the reason, and asserts the number it collects from each file.
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
JAX_ROOT = TESTS.parent / JAX_PKG

#: JAX modules whose counterpart is a public module of the port, one that
#: holds a device: a name is looked up there first, then in the host copy
#: ``host/<module>``.  ``pipeline.manager`` is faced by ``pipeline``, whose
#: ``PipelineManager`` builds the registry of its device.
PUBLIC = {"av": "av", "av.media_player": "av.media_player",
          "pipeline": "pipeline", "pipeline.animator": "pipeline.animator",
          "pipeline.manager": "pipeline", "codecs": "codecs",
          "codecs.flac": "codecs.flac", "codecs.aac": "codecs.aac",
          "codecs.mp3": "codecs.mp3"}


def _host(rest: str) -> str:
    return f"{PORT_PKG}.host" + (f".{rest}" if rest else "")


def _homes(rest: str) -> list:
    """The port's modules that hold the names of the JAX module ``rest``
    (a dotted path below the package), in lookup order."""
    homes = [f"{PORT_PKG}.{PUBLIC[rest]}"] if rest in PUBLIC else []
    return [*homes, _host(rest)]


def _import(name: str):
    """The module ``name``, or None where the port has no such module."""
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name == name or name.startswith(f"{e.name}."):
            return None
        raise


def _jax_path(rest: str) -> pathlib.Path:
    """The JAX module ``rest``'s package directory, or its file less
    ``.py``."""
    return JAX_ROOT.joinpath(*rest.split(".")) if rest else JAX_ROOT


def _is_jax_module(rest: str) -> bool:
    path = _jax_path(rest)
    return path.is_dir() or path.with_suffix(".py").is_file()


@functools.cache
def _reexports(rest: str) -> dict:
    """Names the JAX module ``rest`` imports from within the package at its
    top level (a package's re-exports): name -> (module, name there)."""
    path = _jax_path(rest)
    src = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    if not src.is_file():
        return {}
    pkg = rest.split(".") if path.is_dir() and rest else \
        rest.split(".")[:-1]
    out = {}
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level:
            base = pkg[:len(pkg) - node.level + 1]
            mod = ".".join([*base, *([node.module] if node.module else [])])
            for a in node.names:
                out[a.asname or a.name] = (mod, a.name)
    return out


_REGISTRIES: dict = {}
_BOUND: dict = {}


def registry(device):
    """The port's codec registry of ``device`` (the JAX package's
    ``codecs.default_registry`` is one registry)."""
    if device not in _REGISTRIES:
        _REGISTRIES[device] = port_codecs.default_registry(device)
    return _REGISTRIES[device]


def on_device(obj, device):
    """``obj`` as the JAX cases get it with ``device`` as the device: a class
    or function of the port that takes ``device`` (or a codec registry)
    gets it by default, and a JAX animator's ``use_device`` flag is
    dropped (the device decides).  Anything else is ``obj`` itself."""
    if obj is port_codecs.default_registry:
        return registry(device)
    if not (inspect.isclass(obj) or inspect.isfunction(obj)) \
            or not getattr(obj, "__module__", "").startswith(PORT_PKG):
        return obj
    try:
        params = inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return obj
    if "device" not in params and "codec_registry" not in params:
        return obj
    if (obj, device) not in _BOUND:
        _BOUND[obj, device] = _bind(obj, params, device)
    return _BOUND[obj, device]


def _bind(obj, params, device):
    names = list(params)
    slot = names.index("device") if "device" in params and \
        params["device"].kind is inspect.Parameter.POSITIONAL_OR_KEYWORD \
        else None

    def arguments(args, kwargs):
        if "use_device" not in params:
            kwargs.pop("use_device", None)
        if slot is not None and len(args) > slot:
            if isinstance(args[slot], bool):         # the JAX use_device
                args = (*args[:slot], device, *args[slot + 1:])
        elif "device" in params:
            kwargs.setdefault("device", device)
        if "codec_registry" in params \
                and len(args) <= names.index("codec_registry") \
                and kwargs.get("codec_registry") is None:
            kwargs["codec_registry"] = registry(device)
        return args, kwargs

    if inspect.isclass(obj):
        def __init__(self, *args, **kwargs):
            args, kwargs = arguments(args, kwargs)
            obj.__init__(self, *args, **kwargs)

        bound = type(obj.__name__, (obj,), {
            "__init__": __init__, "__module__": obj.__module__,
            "__qualname__": obj.__qualname__, "__doc__": obj.__doc__})
    else:
        @functools.wraps(obj)
        def bound(*args, **kwargs):
            args, kwargs = arguments(args, kwargs)
            return obj(*args, **kwargs)
    bound.__port_original__ = obj
    return bound


def lookup(rest: str, name: str, device):
    """The port's object for the name ``name`` of the JAX module ``rest``."""
    sub = f"{rest}.{name}" if rest else name
    if _is_jax_module(sub):
        return module_view(sub, device)
    for home in _homes(rest):
        mod = _import(home)
        if mod is not None and hasattr(mod, name):
            return on_device(getattr(mod, name), device)
    if name in _reexports(rest):
        return lookup(*_reexports(rest)[name], device)
    raise ImportError(f"the port has no counterpart of "
                      f"{JAX_PKG}.{rest}.{name}")


class ModuleView(types.ModuleType):
    """A package or public module of the JAX package as the cases see it in
    the port: each attribute is :func:`lookup`'s, and setting one (a
    monkeypatch) sets it in the port's module that holds it."""

    def __init__(self, rest: str, device):
        super().__init__(f"{JAX_PKG}.{rest}".rstrip("."))
        self.__dict__["__port_rest__"] = rest
        self.__dict__["__port_device__"] = device

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            return lookup(self.__port_rest__, name, self.__port_device__)
        except ImportError as e:
            raise AttributeError(str(e)) from None

    def _holder(self, name):
        mods = [m for m in map(_import, _homes(self.__port_rest__)) if m]
        return next((m for m in mods if hasattr(m, name)), mods[-1])

    def __setattr__(self, name, value):
        setattr(self._holder(name), name,
                getattr(value, "__port_original__", value))

    def __delattr__(self, name):
        delattr(self._holder(name), name)


def module_view(rest: str, device):
    """The JAX module ``rest`` in the port: a :class:`ModuleView` for a
    package or a public module (where names are re-exported or take a
    device), else the port's host copy itself."""
    if rest in PUBLIC or _jax_path(rest).is_dir():
        return ModuleView(rest, device)
    mod = _import(_host(rest))
    if mod is None:
        raise ImportError(f"the port has no counterpart of {JAX_PKG}.{rest}")
    return mod


def resolve(module: str, name: str, device="cpu"):
    """The port's object for ``from module import name``, ``module`` a
    module of the JAX package, on ``device``."""
    return lookup(module[len(JAX_PKG) + 1:], name, device)


def is_jax_test_file(module: str) -> bool:
    """Whether ``module`` names a test file of the JAX package here."""
    return module.startswith("test_") and not module.startswith("test_torch") \
        and (TESTS / f"{module}.py").is_file()


class PortImports(ast.NodeTransformer):
    """Turns each import of the JAX package into assignments from
    :func:`resolve`, an import of a sibling JAX test file into assignments
    from that file as this loader runs it, and ``__import__`` of a JAX module
    into its port counterpart."""

    def _assign(self, node, target: str, func: str, module: str, name):
        call = ast.Call(
            func=ast.Name(func, ast.Load()),
            args=[ast.Constant(module), ast.Constant(name)], keywords=[])
        return ast.copy_location(
            ast.Assign(targets=[ast.Name(target, ast.Store())], value=call),
            node)

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if node.level:
            return node
        if is_jax_test_file(mod):
            return [self._assign(node, a.asname or a.name, "__port_sibling__",
                                 mod, a.name) for a in node.names]
        if mod.split(".")[0] != JAX_PKG:
            return node
        return [self._assign(node, a.asname or a.name, "__port_import__",
                             mod, a.name) for a in node.names]

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
            out.append(self._assign(node, a.asname, "__port_import__", module,
                                    name))
        return out

    def visit_Call(self, node):
        """``__import__("ohpipeline_tpu.a.b", fromlist=[...])`` is the port's
        ``a.b``."""
        self.generic_visit(node)
        if isinstance(node.func, ast.Name) and node.func.id == "__import__" \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and str(node.args[0].value).split(".")[0] == JAX_PKG:
            module, _, name = node.args[0].value.rpartition(".")
            return ast.copy_location(ast.Call(
                func=ast.Name("__port_import__", ast.Load()),
                args=[ast.Constant(module), ast.Constant(name)],
                keywords=[]), node)
        return node


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


@functools.cache
def load(filename: str, device="cpu") -> types.ModuleType:
    """The JAX test file ``filename``, run with its imports in the port (on
    ``device``) and its fixtures renamed."""
    path = TESTS / filename
    tree = ast.parse(path.read_text(), str(path))
    tree = RenameFixtures(tree, path.stem[len("test_"):]).visit(tree)
    tree = PortImports().visit(tree)
    ast.fix_missing_locations(tree)
    mod = types.ModuleType(f"jax_cases_{path.stem}")
    mod.__file__ = str(path)
    mod.__dict__["__port_import__"] = functools.partial(resolve,
                                                        device=device)
    mod.__dict__["__port_sibling__"] = \
        lambda module, name: getattr(load(f"{module}.py", device), name)
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


def collect(filename: str, namespace: dict, device="cpu", leave_out=(),
            marks=()) -> list:
    """Puts the cases of ``filename`` (and its module-level fixtures) into
    ``namespace``, the case functions named in ``leave_out`` left out, each
    case with the file's own marks and ``marks``.  Returns (file, class or
    None, function) of each case collected."""
    mod = load(filename, device)
    stem = filename[len("test_"):-len(".py")]
    own = getattr(mod, "pytestmark", [])        # the file's own skips
    marks = [*(own if isinstance(own, list) else [own]), *marks]
    assert set(leave_out) <= set(vars(mod)), f"{filename}: {leave_out}"
    cases = []
    for name, obj in list(vars(mod).items()):
        if name in leave_out:
            continue
        if (inspect.isclass(obj) and name.startswith("Test")
                or inspect.isfunction(obj) and name.startswith("test_")) \
                and obj.__module__ == mod.__name__:
            for mark in marks:
                obj = mark(obj)
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
