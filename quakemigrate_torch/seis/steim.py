# -*- coding: utf-8 -*-
"""
STEIM1/STEIM2 miniSEED codec: ctypes bindings to the port's own copy of
the C codec (``csrc/host/steimlib.c``), built with the host C compiler at
first use (:func:`quakemigrate_torch._build.build_host`). There is no
pure-Python substitute: a failed build raises.

"""

import ctypes
import functools

import numpy as np
import numpy.ctypeslib as clib

from quakemigrate_torch import _build

_U8P = clib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_I32P = clib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_I64P = clib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(_build.build_host()))
    for name in ("steim1_decode", "steim2_decode"):
        fn = getattr(lib, name)
        fn.argtypes = [_U8P, _I64, _I64, _I32P, ctypes.c_int]
        fn.restype = _I64
    for name in ("steim1_encode", "steim2_encode"):
        fn = getattr(lib, name)
        fn.argtypes = [_I32P, _I64, _I32, _U8P, _I64, ctypes.POINTER(_I64)]
        fn.restype = _I64
    lib.steim_decode_records.argtypes = [
        _U8P, _I64P, _I64P, _U8P, _I64, _I64, _I64, ctypes.c_int, _I32P,
    ]
    lib.steim_decode_records.restype = _I64
    lib.steim_encode_records.argtypes = [
        _I32P, _I64, _I64, ctypes.c_int, _U8P, _I64, _I64P, _U8P,
    ]
    lib.steim_encode_records.restype = _I64
    return lib


def steim_decode(frames, nsamples, encoding, little_endian=False):
    """
    Decode STEIM1/2 frames (bytes or uint8 array) into int32 samples.
    ``encoding`` is the SEED code: 10 for STEIM1, 11 for STEIM2. Set
    ``little_endian`` for payloads whose Blockette-1000 word order is 0.

    """

    frames = np.frombuffer(bytes(frames), dtype=np.uint8)
    out = np.empty(nsamples, dtype=np.int32)
    lib = _lib()
    fn = lib.steim2_decode if encoding == 11 else lib.steim1_decode
    n = fn(frames, len(frames) // 64, nsamples, out, int(little_endian))
    if n < 0:
        raise ValueError("Malformed STEIM data.")
    if n < nsamples:
        raise ValueError(
            f"STEIM decode produced {n} of {nsamples} expected samples."
        )
    return out


def steim_encode(samples, prev, nframes, encoding):
    """
    Encode int32 ``samples`` into up to ``nframes`` STEIM frames.

    Returns (nsamples_consumed, frame_bytes). Raises ValueError if a STEIM2
    difference overflows 30 bits (callers fall back to STEIM1).

    """

    samples = np.ascontiguousarray(samples, dtype=np.int32)
    out = np.zeros(nframes * 64, dtype=np.uint8)
    used = _I64(0)
    lib = _lib()
    fn = lib.steim2_encode if encoding == 11 else lib.steim1_encode
    n = fn(samples, len(samples), _I32(int(prev)), out, nframes,
           ctypes.byref(used))
    if n < 0:
        raise ValueError("STEIM2 difference overflow; fall back to STEIM1.")
    return int(n), out[: used.value * 64].tobytes()


def steim_decode_records(buf, offsets, npts, enc, data_offset, reclen,
                         little_endian=False):
    """
    Decode a batch of same-geometry miniSEED records in one native call.
    ``buf`` is the raw file bytes; ``offsets``/``npts``/``enc`` are
    per-record arrays (enc: SEED code 10/11 per record; STEIM2 files may
    hold per-record STEIM1 fallbacks). Returns the concatenated int32
    samples. Raises ValueError naming the failing record if any record is
    malformed or under-produces.

    """

    buf = np.frombuffer(buf, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    npts = np.ascontiguousarray(npts, dtype=np.int64)
    enc = np.ascontiguousarray(enc, dtype=np.uint8)
    out = np.empty(int(npts.sum()), dtype=np.int32)
    n = _lib().steim_decode_records(
        buf, offsets, npts, enc, len(offsets), int(data_offset), int(reclen),
        int(little_endian), out,
    )
    if n < 0:
        raise ValueError(f"Malformed STEIM data in record {-n - 1}.")
    return out


def steim_encode_records(samples, nframes, encoding):
    """
    Pack a whole int32 array into consecutive records' frame payloads in
    one native call. Returns (payloads [n_records, nframes*64] uint8,
    consumed [n_records] int64, rec_enc [n_records] uint8); rec_enc holds
    10 where a STEIM2 record fell back to STEIM1.

    """

    samples = np.ascontiguousarray(samples, dtype=np.int32)
    frame_bytes = int(nframes) * 64
    # Worst case one sample per data word: 13 words in frame 0 (words
    # 0-2 are ctrl + integration constants), 15 in every later frame.
    min_per_record = 13 + (int(nframes) - 1) * 15
    max_records = max(1, -(-len(samples) // min_per_record))
    out = np.zeros(max_records * frame_bytes, dtype=np.uint8)
    consumed = np.zeros(max_records, dtype=np.int64)
    rec_enc = np.zeros(max_records, dtype=np.uint8)
    n = _lib().steim_encode_records(
        samples, len(samples), int(nframes), int(encoding), out, max_records,
        consumed, rec_enc,
    )
    if n < 0:
        raise ValueError("steim_encode_records: record budget exceeded")
    return (
        out[: n * frame_bytes].reshape(n, frame_bytes),
        consumed[:n],
        rec_enc[:n],
    )
