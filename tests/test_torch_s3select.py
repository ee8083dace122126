"""The reference's S3 Select cases against the port's copies of
s3select/sql.py and s3select/select.py.

Every case of tests/test_s3select.py and tests/test_s3select_functions.py
runs here once more, unchanged, with its module's names bound to the
port: the names the module imported from minio_tpu, and the imports
inside the cases (S3Error, the signature and server modules, the
Aggregator), resolve to minio_tpu_torch. The one thing the port does not
have, the single-path FS backend the HTTP case stores its object on, is a
stand-in here: the port's erasure sets over four drives on the host.
"""

from __future__ import annotations

import builtins
import importlib
import types

import pytest

import tests.test_s3select as select_cases
import tests.test_s3select_functions as function_cases
from minio_tpu_torch.object.sets import ErasureSets

_OPEN: list = []


class _PortFS:
    """minio_tpu.object.fs.FSObjects(root) as the HTTP case uses it,
    over the port's sets (device="cpu")."""

    def __init__(self, root: str):
        self.sets = ErasureSets.from_drives(
            [f"{root}/d{i}" for i in range(4)], set_count=1,
            set_drive_count=4, parity=2, block_size=1 << 16, device="cpu")
        _OPEN.append(self.sets)

    def __getattr__(self, name):
        return getattr(self.sets, name)


_STANDINS = {"minio_tpu.object.fs": types.SimpleNamespace(
    FSObjects=_PortFS)}


def _port_name(name: str) -> str:
    return "minio_tpu_torch" + name[len("minio_tpu"):]


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and (name == "minio_tpu" or name.startswith("minio_tpu.")):
        if name in _STANDINS:
            return _STANDINS[name]
        name = _port_name(name)
    return builtins.__import__(name, globals, locals, fromlist, level)


def _on_port(module) -> dict:
    """The module's namespace with every minio_tpu name rebound to the
    port's, and its functions re-made over that namespace."""
    ns = dict(vars(module))
    ns["__builtins__"] = dict(vars(builtins), __import__=_import)
    for k, v in list(ns.items()):
        home = getattr(v, "__module__", None) or ""
        if home.startswith("minio_tpu.") and hasattr(v, "__name__"):
            ns[k] = getattr(importlib.import_module(_port_name(home)),
                            v.__name__)
    for k, v in list(ns.items()):
        if isinstance(v, types.FunctionType) \
                and v.__module__ == module.__name__:
            ns[k] = types.FunctionType(v.__code__, ns, v.__name__,
                                       v.__defaults__, v.__closure__)
    return ns


_SELECT = _on_port(select_cases)
_FUNCTIONS = _on_port(function_cases)


def _cases(module) -> list[str]:
    return sorted(n for n in vars(module) if n.startswith("test_")
                  and n != "test_function_conformance")


@pytest.fixture(autouse=True)
def _close_sets():
    yield
    while _OPEN:
        _OPEN.pop().close()


def test_names_resolve_to_the_port():
    assert _SELECT["run_select"].__module__ == \
        "minio_tpu_torch.s3select.select"
    assert _FUNCTIONS["evaluate"].__module__ == \
        "minio_tpu_torch.s3select.sql"
    assert _SELECT["rows"].__globals__ is _SELECT


@pytest.mark.parametrize("name", _cases(select_cases))
def test_s3select_case(name, tmp_path):
    fn = _SELECT[name]
    args = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    fn(**({"tmp_path": tmp_path} if "tmp_path" in args else {}))
    if "tmp_path" in args:
        assert _OPEN, "the case did not store through the port's sets"


@pytest.mark.parametrize("name", _cases(function_cases))
def test_s3select_functions_case(name):
    _FUNCTIONS[name]()


@pytest.mark.parametrize("expr,want", function_cases.TABLE,
                         ids=[t[0][:60] for t in function_cases.TABLE])
def test_function_conformance(expr, want):
    _FUNCTIONS["test_function_conformance"](expr, want)
