# -*- coding: utf-8 -*-
"""
The C API table of quakemigrate_torch's kernel library (``_build.py``)
against the sources: every ``extern "C"`` function of ``csrc/*.cu`` has an
entry in ``_build.SIGNATURES`` with one ctypes type per parameter, a
pointer (``c_void_p``) where the prototype has a pointer and a
``c_int`` where it has an ``int``, and no entry names a function that is
not there. Without an entry ctypes would pass a pointer as a 32-bit int.
Runs on the CPU: it reads the sources, it builds nothing.

"""

import ctypes
import re

import pytest

from quakemigrate_torch import _build

_EXTERN_C = re.compile(
    r'extern\s+"C"\s+[^(;{]*?\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _prototypes():
    """{name: [parameter declarations]} of every extern "C" function."""

    found = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        for m in _EXTERN_C.finditer(src.read_text()):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            assert m.group(1) not in found, f"{m.group(1)} defined twice"
            found[m.group(1)] = [p for p in params if p not in ("", "void")]
    return found


def test_every_extern_c_function_has_an_entry():
    found = _prototypes()
    assert "qm_migrate_detect" in found and "qm_error_string" in found
    assert sorted(set(found) - set(_build.SIGNATURES)) == []


def test_no_entry_is_stale():
    assert sorted(set(_build.SIGNATURES) - set(_prototypes())) == []


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_entry_types_match_the_prototype(name):
    params = _prototypes()[name]
    argtypes = _build.SIGNATURES[name]
    assert len(argtypes) == len(params), (name, params)
    for param, argtype in zip(params, argtypes):
        want = ctypes.c_void_p if "*" in param else ctypes.c_int
        assert param.startswith(("int ", "const void*", "void*")), param
        assert argtype is want, (name, param, argtype)
