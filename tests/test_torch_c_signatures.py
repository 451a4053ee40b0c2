"""Every C entry of the port's libraries against the ctypes signature that
its caller declares (``_build.Library``): the same number of arguments,
each of the same kind, and the same return kind.

The prototypes are read from the sources themselves, every ``extern "C"``
function of ``simplestereo_tpu_torch/csrc/*.cu`` and
``simplestereo_tpu_torch/native/_*.cpp``; a library is declared by the
module that calls it. A ctypes list that does not match its C prototype
passes wrong values, or corrupts memory, without an error, and only a
card would show it: here it fails on the CPU, one case an entry.
"""

import ctypes
import functools
import importlib
import pathlib
import re

import pytest

from simplestereo_tpu_torch import _build

PACKAGE = pathlib.Path(_build.__file__).resolve().parent

# C type -> ctypes kind; any pointer but char* is a plain pointer.
KINDS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
         "float": ctypes.c_float, "double": ctypes.c_double}


def _kind(decl):
    """The ctypes type of one C parameter or return declaration."""
    decl = re.sub(r"\bconst\b", " ", decl)
    if "*" in decl:
        base = decl[:decl.index("*")].split()
        return ctypes.c_char_p if base == ["char"] else ctypes.c_void_p
    words = decl.split()
    if len(words) > 1 and words[-1] not in ("int", "long", "float",
                                            "double"):
        words = words[:-1]  # the parameter's name
    return KINDS[" ".join(words)]


def _strip_bodies(text):
    """``text`` with the contents of every top-level brace pair removed."""
    out, depth = [], 0
    for ch in text:
        if ch == "{":
            depth += 1
            if depth == 1:
                out.append("{")
            continue
        if ch == "}":
            depth -= 1
            if depth == 0:
                out.append("}")
            continue
        if depth == 0:
            out.append(ch)
    return "".join(out)


PROTO = re.compile(r"([A-Za-z_][\w\s\*]*?[\s\*])(\w+)\s*\(([^()]*)\)\s*\{")


def prototypes(path):
    """{entry: (argument kinds, return kind)} of the ``extern "C"``
    functions of one source file."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", path.read_text(), flags=re.S)
    decls = []
    for m in re.finditer(r'extern\s+"C"\s*', text):
        rest = text[m.end():]
        if rest.startswith("{"):  # a block: its top-level functions
            depth, end = 0, 0
            for end, ch in enumerate(rest):
                depth += (ch == "{") - (ch == "}")
                if depth == 0:
                    break
            decls += PROTO.findall(_strip_bodies(rest[1:end]))
        else:
            decls.append(PROTO.match(rest).groups())
    out = {}
    for ret, name, params in decls:
        params = [p for p in params.split(",") if p.strip()]
        if params == ["void"]:
            params = []
        out[name] = ([_kind(p) for p in params], _kind(ret))
    return out


def _library_name(path):
    return path.stem if path.suffix == ".cu" else path.stem[1:]


SOURCES = sorted(PACKAGE.glob("csrc/*.cu")) + sorted(
    PACKAGE.glob("native/_*.cpp"))
ENTRIES = [(_library_name(p), entry, sig) for p in SOURCES
           for entry, sig in prototypes(p).items()]


@functools.cache
def declared():
    """{name: library} of every ``_build.Library`` that a module of the
    package holds: each module whose source builds one is imported and its
    attributes read. A library declared twice fails here."""
    libs = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        if "_build.Library(" in path.read_text():
            rel = path.relative_to(PACKAGE.parent).with_suffix("")
            module = importlib.import_module(".".join(
                p for p in rel.parts if p != "__init__"))
            for lib in vars(module).values():
                if isinstance(lib, _build.Library):
                    assert lib.name not in libs, f"{lib.name} declared twice"
                    libs[lib.name] = lib
    return libs


def test_every_library_is_declared_and_every_entry_is_in_its_source():
    libs = declared()
    assert sorted(libs) == sorted(sum(_build.library_names(), []))
    in_source = {(lib, entry) for lib, entry, _ in ENTRIES}
    for name, lib in libs.items():
        for entry in lib.signatures:
            assert (name, entry) in in_source, (name, entry)


@pytest.mark.parametrize("lib, entry, sig", ENTRIES,
                         ids=[f"{lib}.{entry}" for lib, entry, _ in ENTRIES])
def test_ctypes_signature_matches_the_c_prototype(lib, entry, sig):
    argtypes, restype = declared()[lib].signatures[entry]
    assert (list(argtypes), restype) == sig


def test_the_parser_reads_both_forms(tmp_path):
    """A lone ``extern "C"`` definition and a block of them, with
    comments, a ``void`` list, ``char*`` and other pointers."""
    src = ('extern "C" const char* a_error(int err) { return ""; }\n'
           '// extern "C" int commented(int x) {}\n'
           'extern "C" {\n'
           'static int helper_count = 0;\n'
           'long long b(const uint8_t* in, long long n, int k, '
           'float* out, double t) { if (n) { return 1; } return 0; }\n'
           'const char* b_error(void) { return ""; }\n'
           'int c(const char* path, unsigned char* rgb) { return 0; }\n'
           '}  // extern "C"\n')
    path = tmp_path / "x.cu"
    path.write_text(src)
    got = prototypes(path)
    P, S = ctypes.c_void_p, ctypes.c_char_p
    assert got == {
        "a_error": ([ctypes.c_int], S),
        "b": ([P, ctypes.c_longlong, ctypes.c_int, P, ctypes.c_double],
              ctypes.c_longlong),
        "b_error": ([], S),
        "c": ([S, P], ctypes.c_int)}
