# -*- coding: utf-8 -*-
"""
quakemigrate_torch.core -- the port's counterpart of the JAX package's
``core``: the fast-marching eikonal solver of the traveltime builders, a
ctypes binding to the port's own copy of the C solver
(``csrc/host/fmmlib.c``, built with the STEIM codec into the host library
at first use by :func:`quakemigrate_torch._build.build_host`), the STEIM
codec's entry points (:mod:`quakemigrate_torch.seis.steim`, re-exported),
the pure-Python STEIM codec (:mod:`.steim_py`), and the reference-shaped
bindings of the compute kernels (:mod:`.compat`). There is no
pure-Python substitute for the solver, and the codec entry points do not
fall back on :mod:`.steim_py`: a failed build raises.

"""

import ctypes
import functools

import numpy as np
import numpy.ctypeslib as clib

from quakemigrate_torch import _build

_F64P = clib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64
_F64 = ctypes.c_double


def native_available():
    """Whether the host library (the C STEIM codec and eikonal solver)
    builds and loads here."""

    try:
        _lib()
    except (OSError, RuntimeError):
        return False
    return True


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(_build.build_host()))
    lib.fast_marching.argtypes = (
        [_F64P] + [_I64] * 3 + [_F64] * 6 + [ctypes.c_int, _F64P])
    lib.fast_marching.restype = ctypes.c_int
    return lib


def fast_marching(velocity, spacing, source_index, order=2):
    """
    Solve |grad T| = 1/v from a point source on a regular grid.

    Parameters
    ----------
    velocity : ndarray, 1-D, 2-D or 3-D
        Velocity at each grid node (grid-projection units per second).
    spacing : sequence of float
        Node spacing per dimension (same units as velocity distances).
    source_index : sequence of float
        Source position in fractional grid-index coordinates.
    order : int
        Upwind stencil order (1 or 2).

    Returns
    -------
    traveltimes : ndarray, same shape as velocity.

    """

    velocity = np.ascontiguousarray(velocity, dtype=np.float64)
    shape = velocity.shape
    # Promote to 3-D with trailing singleton dimensions
    pad = 3 - velocity.ndim
    full_shape = tuple(shape) + (1,) * pad
    spacing = list(np.atleast_1d(spacing).astype(float)) + [1.0] * pad
    source = list(np.atleast_1d(source_index).astype(float)) + [0.0] * pad
    tt = np.empty(full_shape, dtype=np.float64)

    status = _lib().fast_marching(
        np.ascontiguousarray(velocity.reshape(full_shape)),
        *[_I64(s) for s in full_shape],
        *[_F64(s) for s in spacing],
        *[_F64(s) for s in source],
        ctypes.c_int(order),
        tt,
    )
    if status != 0:
        raise MemoryError("fast_marching failed to allocate working memory.")
    return tt.reshape(shape)


from quakemigrate_torch.seis.steim import (  # noqa: E402,F401
    steim_decode,
    steim_decode_records,
    steim_encode,
    steim_encode_records,
)
from quakemigrate_torch.core.compat import (  # noqa: E402,F401
    centred_sta_lta,
    find_max_coa,
    migrate,
    overlapping_sta_lta,
    recursive_sta_lta,
)
