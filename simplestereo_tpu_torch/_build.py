"""
Build the package's C sources at first use and bind them with ctypes.

A library is found by its name: ``csrc/<name>.cu`` is compiled by
``nvcc`` and ``native/_<name>.cpp`` by ``g++``, into
``build/simplestereo_tpu_torch/lib<name>-<hash>.so`` at the root of the
checkout, keyed by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Each source
has a plain C interface, which keeps the build to seconds. Nothing is
fetched: the sources are the repository's own.

The module that calls a library declares it as a :class:`Library`, with
the ctypes signatures of the C entries it calls. Nothing is built at
import. A CUDA entry takes the device's index and a stream last and
returns ``cudaGetLastError()`` of its launches, which
:meth:`Library.launch` turns into a ``RuntimeError``; a host entry
returns 0 or an error code, which its caller reads.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PACKAGE = pathlib.Path(__file__).resolve().parent
_CSRC = _PACKAGE / "csrc"
_NATIVE = _PACKAGE / "native"
BUILD_DIR = _PACKAGE.parent / "build" / "simplestereo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

# CUDA's limits on a grid's extents; the matchers' kernels put the frames
# of a stack on y or z.
GRID_X_MAX = 2**31 - 1
GRID_YZ_MAX = 65_535


def frame_pieces(B, per_launch):
    """[(b0, b1), ...]: the frames [0, B) cut, in order, into launches of
    at most ``per_launch`` frames each. Frames are independent, so the
    pieces give what one launch of the whole stack would, bit for bit."""
    if per_launch < 1:
        raise ValueError(f"per_launch must be >= 1, got {per_launch}")
    return [(b, min(b + per_launch, B)) for b in range(0, B, per_launch)]


def library_names():
    """(CUDA, host): the names of the libraries in ``csrc/`` and in
    ``native/``, sorted."""
    return (sorted(p.stem for p in _CSRC.glob("*.cu")),
            sorted(p.stem[1:] for p in _NATIVE.glob("_*.cpp")))


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (nvcc on PATH or CUDA_HOME)")
    return found


def _gxx():
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: building the host libraries "
                           "needs a C++17 compiler on PATH")
    return found


def _flags(src):
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS


def _library_path(name):
    """(source, build) of the library ``name``."""
    src = _CSRC / f"{name}.cu"
    if not src.exists():
        src = _NATIVE / f"_{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(_flags(src)).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_log(name):
    """The compiler's output (for nvcc, ptxas's register and spill report)
    for ``name``'s current build, or '' when it was not built by this
    checkout yet."""
    log = _library_path(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names):
    """Compile the source of each library of ``names`` whose build is
    missing: one compiler per source, all started together, so a cold
    build of every library takes as long as the slowest source rather
    than their sum. Returns when every one has finished; raises if any
    failed."""
    jobs = []
    for name in names:
        src, lib_path = _library_path(name)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        log = lib_path.with_suffix(f".{os.getpid()}.tmplog")
        compiler = _nvcc() if src.suffix == ".cu" else _gxx()
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [compiler, *_flags(src), "-o", str(tmp), str(src)],
                stdout=out, stderr=subprocess.STDOUT)
        jobs.append((src, lib_path, tmp, log, proc))
    failed = []
    for src, lib_path, tmp, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"build failed for {src.name} (exit "
                          f"{proc.returncode}):\n{log.read_text()}")
            tmp.unlink(missing_ok=True)
            log.unlink()
            continue
        os.replace(log, lib_path.with_suffix(".log"))
        os.replace(tmp, lib_path)  # atomic: concurrent builds race safely
    if failed:
        raise RuntimeError("\n".join(failed))


def bind(lib, signatures):
    """Set the ctypes signatures ``{entry: (argtypes, restype)}`` on the
    loaded library ``lib``; returns it."""
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


class Library:
    """A library of the package as its caller declares it: ``name`` and
    the ctypes signatures ``{entry: (argtypes, restype)}`` of the C
    entries it calls. One module declares a library, once."""

    def __init__(self, name, signatures):
        self.name, self.signatures = name, signatures
        self.loaded = None  # the ctypes library once load() has run

    def load(self):
        """The library, built if its build is missing, loaded once."""
        if self.loaded is None:
            build([self.name])
            self.loaded = bind(ctypes.CDLL(str(_library_path(self.name)[1])),
                               self.signatures)
        return self.loaded

    def _call(self, entry, args, what):
        lib = self.load()
        err = getattr(lib, entry)(*args)
        if err != 0:
            error = next(e for e in self.signatures
                         if e.endswith("_error_string"))
            raise RuntimeError(f"{what}: {getattr(lib, error)(err).decode()}")

    def launch(self, entry, device, *args, what):
        """Call the CUDA ``entry`` with ``args``, then ``device``'s index
        and its current stream; a nonzero return raises ``RuntimeError``
        with ``what``, a colon and the CUDA error's text."""
        stream = torch.cuda.current_stream(device).cuda_stream
        self._call(entry, (*args, device.index, stream), what)

    def occupancy(self, entry, device, *args, what):
        """(registers a thread, spill bytes a thread, blocks resident per
        SM) of a kernel, from the occupancy ``entry`` called with ``args``,
        the index of ``device`` (default the current CUDA device) and an
        int[3] it fills; raises as :meth:`launch` does."""
        dev = torch.device("cuda" if device is None else device)
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        info = (ctypes.c_int * 3)()
        self._call(entry, (*args, idx, ctypes.cast(info, ctypes.c_void_p)),
                   what)
        return tuple(info)
