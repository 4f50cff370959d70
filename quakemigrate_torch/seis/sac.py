# -*- coding: utf-8 -*-
"""
Minimal SAC binary waveform format support (read/write), the port's copy
of the JAX package's ``seis/sac.py``: read by ``seis.read`` (and so by
``Archive``), written by ``Stream.write`` (and so by the cut-waveform
writer). Implements the standard 632-byte header (70 floats, 40 ints, 192
chars) + float32 data section.

"""

from __future__ import annotations

import struct

import numpy as np

from .trace import Stream, Trace
from .utcdatetime import UTCDateTime

_UNDEF_F = -12345.0
_UNDEF_I = -12345


def write_sac(stream, path, byteorder="<", extra_headers=None):
    """
    Write a Stream to SAC files. SAC holds one trace per file: if the stream
    has multiple traces, an index suffix is appended to the filename.
    ``extra_headers`` maps header names (e.g. "user0", "kt0", "evla") to
    values, applied to every trace.

    """

    multi = len(stream) > 1
    for i, tr in enumerate(stream):
        fname = f"{path}.{i:02d}" if multi else str(path)
        _write_sac_trace(tr, fname, byteorder, extra_headers or {})


_FLOAT_HDR = {
    "delta": 0, "scale": 3, "b": 5, "e": 6, "o": 7, "a": 8,
    "t0": 10, "t1": 11, "t2": 12, "t3": 13, "t4": 14,
    "t5": 15, "t6": 16, "t7": 17, "t8": 18, "t9": 19,
    "stla": 31, "stlo": 32, "stel": 33, "stdp": 34,
    "evla": 35, "evlo": 36, "evel": 37, "evdp": 38, "mag": 39,
    "user0": 40, "user1": 41, "user2": 42, "user3": 43, "user4": 44,
    "user5": 45, "user6": 46, "user7": 47, "user8": 48, "user9": 49,
    "dist": 50, "az": 51, "baz": 52, "gcarc": 53, "cmpaz": 57, "cmpinc": 58,
}
_INT_HDR = {
    "nzyear": 0, "nzjday": 1, "nzhour": 2, "nzmin": 3, "nzsec": 4,
    "nzmsec": 5, "nvhdr": 6, "npts": 9, "iftype": 15, "iztype": 17,
    "leven": 35,
}
_CHAR_HDR = {  # name -> (offset, length) within the 192-char block
    "kstnm": (0, 8), "kevnm": (8, 16),
    "kt0": (48, 8), "kt1": (56, 8), "kt2": (64, 8), "kt3": (72, 8),
    "khole": (24, 8), "ko": (32, 8), "ka": (40, 8),
    "kcmpnm": (160, 8), "knetwk": (168, 8),
}


def _write_sac_trace(tr, fname, byteorder, extra):
    floats = np.full(70, _UNDEF_F, dtype=byteorder + "f4")
    ints = np.full(40, _UNDEF_I, dtype=byteorder + "i4")
    chars = bytearray(b" " * 192)
    for name in ("kstnm", "kevnm", "khole", "kcmpnm", "knetwk"):
        off, length = _CHAR_HDR[name]
        chars[off : off + length] = b"-12345  "[:length].ljust(length)

    start = tr.stats.starttime
    floats[_FLOAT_HDR["delta"]] = tr.stats.delta
    floats[_FLOAT_HDR["b"]] = 0.0
    floats[_FLOAT_HDR["e"]] = (tr.stats.npts - 1) * tr.stats.delta
    ints[_INT_HDR["nzyear"]] = start.year
    ints[_INT_HDR["nzjday"]] = start.julday
    ints[_INT_HDR["nzhour"]] = start.hour
    ints[_INT_HDR["nzmin"]] = start.minute
    ints[_INT_HDR["nzsec"]] = start.second
    ints[_INT_HDR["nzmsec"]] = start.microsecond // 1000
    # Sub-millisecond remainder goes into 'b'
    floats[_FLOAT_HDR["b"]] = (start.microsecond % 1000) / 1e6
    floats[_FLOAT_HDR["e"]] = floats[_FLOAT_HDR["b"]] + (
        tr.stats.npts - 1
    ) * tr.stats.delta
    ints[_INT_HDR["nvhdr"]] = 6
    ints[_INT_HDR["npts"]] = tr.stats.npts
    ints[_INT_HDR["iftype"]] = 1  # ITIME
    ints[_INT_HDR["iztype"]] = 9  # IB
    ints[_INT_HDR["leven"]] = 1

    def _set_char(name, value):
        off, length = _CHAR_HDR[name]
        chars[off : off + length] = str(value)[:length].ljust(length).encode()

    _set_char("kstnm", tr.stats.station)
    _set_char("kcmpnm", tr.stats.channel)
    _set_char("knetwk", tr.stats.network)

    for key, value in extra.items():
        if key in _FLOAT_HDR:
            floats[_FLOAT_HDR[key]] = value
        elif key in _INT_HDR:
            ints[_INT_HDR[key]] = value
        elif key in _CHAR_HDR:
            _set_char(key, value)

    data = np.asarray(tr.data, dtype=byteorder + "f4")
    with open(fname, "wb") as f:
        f.write(floats.tobytes())
        f.write(ints.tobytes())
        f.write(bytes(chars))
        f.write(data.tobytes())


def read_sac(path):
    """Read a single-trace SAC binary file into a Stream."""

    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 632:
        raise TypeError("File too short to be SAC.")

    for byteorder in ("<", ">"):
        nvhdr = struct.unpack_from(byteorder + "i", buf, 70 * 4 + 6 * 4)[0]
        if 1 <= nvhdr <= 10:
            break
    else:
        raise TypeError("Not a SAC file (bad nvhdr).")

    floats = np.frombuffer(buf, dtype=byteorder + "f4", count=70)
    ints = np.frombuffer(buf, dtype=byteorder + "i4", count=40, offset=280)
    chars = buf[440:632]

    npts = int(ints[_INT_HDR["npts"]])
    if npts < 0 or 632 + 4 * npts > len(buf):
        raise ValueError(
            f"SAC header claims {npts} samples but the file holds at most "
            f"{(len(buf) - 632) // 4}."
        )
    data = np.frombuffer(
        buf, dtype=byteorder + "f4", count=npts, offset=632
    ).astype(np.float32)

    start = UTCDateTime(
        year=int(ints[0]), julday=int(ints[1]), hour=int(ints[2]),
        minute=int(ints[3]), second=int(ints[4]),
    ) + int(ints[5]) / 1000.0
    b = float(floats[_FLOAT_HDR["b"]])
    if b != _UNDEF_F and np.isfinite(b):
        start = start + b

    delta = float(floats[_FLOAT_HDR["delta"]])
    if not np.isfinite(delta) or delta <= 0.0:
        raise ValueError(f"SAC header has invalid sample interval {delta}.")

    def _get_char(name):
        off, length = _CHAR_HDR[name]
        value = chars[off : off + length].decode("ascii", "replace").strip()
        return "" if value == "-12345" else value

    tr = Trace(
        data,
        {
            "station": _get_char("kstnm"),
            "channel": _get_char("kcmpnm"),
            "network": _get_char("knetwk"),
            "starttime": start,
            "sampling_rate": 1.0 / delta,
        },
    )
    return Stream([tr])
