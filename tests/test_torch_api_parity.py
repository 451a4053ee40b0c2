"""PyTorch port: every public name of the JAX package has a counterpart.

Walks the public modules of ``simplestereo_tpu`` and the names each
defines (its ``__all__``, else its public functions and classes from the
package and its constants) and asserts that the port's module of the same
path has each of them. The Pallas modules map to their CUDA counterparts
(``passive/asw_pallas.py`` -> ``passive/asw_cuda.py``, a ``*_pallas`` name
-> ``*_cuda``). What the port leaves out is the allow-list below, each
entry with its reason; an entry the port has since filled fails the test,
so the list cannot go stale.

A compiled extension of the JAX package is listed by the walk only once it
has been built in the source tree; an allow-listed module whose C++ source
lies beside the package (``native._ply`` -> ``native/_ply.cpp``) is walked
all the same, so a fresh checkout has the same cases as a built one.
"""

import inspect
import importlib
import pathlib
import pkgutil

import pytest

import simplestereo_tpu

ALLOWED_MODULES = {
    "simplestereo_tpu.native._ply": (
        "the JAX package's CPython extension module; the port builds the "
        "same C++ as a plain C library bound with ctypes "
        "(native.write_ply, native.read_ply)"),
}
ALLOWED_NAMES = {
    ("simplestereo_tpu.native", "get_ply"): (
        "builds and imports the CPython extension above; the port's host "
        "libraries load through _build.Library"),
}
MODULE_MAP = {
    "simplestereo_tpu.passive.asw_pallas": "simplestereo_tpu_torch.passive.asw_cuda",
    "simplestereo_tpu.passive.sgm_pallas": "simplestereo_tpu_torch.passive.sgm_cuda",
    "simplestereo_tpu.passive.gsw_pallas": "simplestereo_tpu_torch.passive.gsw_cuda",
}
# Names whose CUDA form is not the generic "_pallas" -> "_cuda".
NAME_MAP = {("simplestereo_tpu.passive.sgm_pallas", "aggregate_pallas"):
            "aggregate"}



def _source_of(module):
    """The C++ source beside the package that ``module`` is built from."""
    parts = module.split(".")[1:]
    return pathlib.Path(simplestereo_tpu.__path__[0]).joinpath(
        *parts).with_suffix(".cpp")


MODULES = sorted({m.name for m in pkgutil.walk_packages(
    simplestereo_tpu.__path__, "simplestereo_tpu.")}
    | {m for m in ALLOWED_MODULES if _source_of(m).exists()})


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    out = set()
    for name, v in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(v):
            continue
        origin = getattr(v, "__module__", None) or ""
        if not callable(v) or origin.startswith("simplestereo_tpu"):
            out.add(name)
    return out


def _port_name(module, name):
    if (module, name) in NAME_MAP:
        return NAME_MAP[(module, name)]
    return name.replace("_pallas", "_cuda") if module in MODULE_MAP else name


def test_walk_finds_the_package():
    assert "simplestereo_tpu.passive.asw_pallas" in MODULES
    assert "simplestereo_tpu.videoio" in MODULES and len(MODULES) > 30


@pytest.mark.parametrize("module", MODULES)
def test_module_has_a_port(module):
    port = MODULE_MAP.get(module, module.replace(
        "simplestereo_tpu", "simplestereo_tpu_torch", 1))
    try:
        tmod = importlib.import_module(port)
    except ImportError:
        assert module in ALLOWED_MODULES, f"{port} is missing"
        return
    assert module not in ALLOWED_MODULES, (
        f"{port} exists now: take it off the allow-list")
    jmod = importlib.import_module(module)
    missing = []
    for name in sorted(_public(jmod)):
        has = hasattr(tmod, _port_name(module, name))
        allowed = (module, name) in ALLOWED_NAMES
        assert not (has and allowed), (
            f"{port}.{name} exists now: take it off the allow-list")
        if not has and not allowed:
            missing.append(name)
    assert not missing, f"{port} lacks {missing}"


def test_allow_list_names_real_jax_names():
    for module, name in ALLOWED_NAMES:
        assert name in _public(importlib.import_module(module))
    for module in ALLOWED_MODULES:
        # walked, or built from a source of the JAX package (see MODULES)
        assert module in MODULES, f"{module}: no such module or source"
    for module, name in NAME_MAP:
        assert name in _public(importlib.import_module(module))
