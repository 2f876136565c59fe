"""The C entry points of ``ep_tpu_torch/csrc`` against the argument types
``ops/_build.py`` gives ctypes for them.

ctypes passes an argument without a declared type as a 32-bit int, which cuts
a pointer, and it cannot see a C signature, so an entry point whose parameter
list changes must change in ``SIGNATURES`` too. This test reads every
``EP_EXPORT int name(...)`` of the sources and holds ``SIGNATURES`` to it: the
same names, the same number of parameters, pointer / ``int`` / ``float`` in
the same places. It runs on the CPU: nothing is compiled.
"""
import ctypes
import re

import pytest

from ep_tpu_torch.ops._build import CSRC_DIR, SIGNATURES

_ENTRY = re.compile(r"EP_EXPORT\s+int\s+(\w+)\s*\(([^)]*)\)", re.S)


def _ctype(param: str):
    param = param.strip()
    if "*" in param:
        return ctypes.c_void_p
    base = param.split()[-2] if len(param.split()) > 1 else param
    return {"int": ctypes.c_int, "float": ctypes.c_float}[base]


def _entry_points() -> dict:
    found = {}
    for src in sorted(CSRC_DIR.glob("*.cu")):
        for name, params in _ENTRY.findall(src.read_text()):
            params = params.strip()
            found[name] = ([] if params in ("", "void")
                           else [_ctype(p) for p in params.split(",")])
    return found


ENTRY_POINTS = _entry_points()


def test_every_entry_point_has_a_signature_and_the_reverse():
    assert sorted(ENTRY_POINTS) == sorted(SIGNATURES)
    assert len(ENTRY_POINTS) >= 15


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_signature_matches_the_c_source(name):
    assert name in ENTRY_POINTS, f"{name} is no EP_EXPORT int function of csrc"
    assert SIGNATURES[name] == ENTRY_POINTS[name]


def test_parser_reads_pointer_int_and_float():
    name, params = _ENTRY.findall(
        "EP_EXPORT int f(const void* x, void* y, int M,\n  float eps, "
        "void* stream) {")[0]
    assert name == "f"
    assert [_ctype(p) for p in params.split(",")] == [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
