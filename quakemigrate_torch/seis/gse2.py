# -*- coding: utf-8 -*-
"""
GSE2.0 waveform I/O with CM6 compression, the port's copy of the JAX
package's ``seis/gse2.py``.

The reference writes cut waveforms in GSE2 via ObsPy
(reference: io/cut_waveforms.py:44-213, format string "GSE2"); this is a
native implementation of the GSE2.0 provisional format: a WID2 header
line, a DAT2 section of CM6 (6-bit, variable-length, second-difference)
compressed integer samples wrapped at 80 columns, and a CHK2 checksum.

"""

import numpy as np

# The CM6 character set: 6 bits per character
_ALPHABET = (
    "+-0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
)
_CHAR_TO_VAL = {c: i for i, c in enumerate(_ALPHABET)}

_CONTINUATION = 0x20  # bit 5: another character follows
_SIGN = 0x10  # bit 4 of the FIRST character: value is negative


def _checksum(data):
    """
    GSE2 CHK2 checksum: running signed sum of the (integer) samples,
    folded into +/-1e8 as it accumulates; the reported value is the
    absolute remainder.

    """

    modulo = 100_000_000
    csum = 0
    for v in np.asarray(data, dtype=np.int64):
        if abs(csum) >= modulo:
            csum -= np.sign(csum) * modulo
        csum += int(v)
    return abs(csum) % modulo


def _second_differences(data):
    d = np.asarray(data, dtype=np.int64)
    out = d.copy()
    out[1:] = d[1:] - d[:-1]
    out2 = out.copy()
    out2[1:] = out[1:] - out[:-1]
    return out2


def _integrate_twice(diffs):
    return np.cumsum(np.cumsum(diffs))


def _encode_cm6(values):
    """CM6-encode an integer array into a string of 6-bit characters."""

    chars = []
    for v in values:
        v = int(v)
        sign = _SIGN if v < 0 else 0
        av = abs(v)
        # Number of characters: the first carries 4 data bits, the rest 5
        n = 1
        while av >= (1 << (4 + 5 * (n - 1))):
            n += 1
        for i in range(n):
            shift = 5 * (n - 1 - i)
            if i == 0:
                bits = (av >> shift) & 0x0F
                c = bits | sign | (_CONTINUATION if n > 1 else 0)
            else:
                bits = (av >> shift) & 0x1F
                c = bits | (_CONTINUATION if i < n - 1 else 0)
            chars.append(_ALPHABET[c])
    return "".join(chars)


def _decode_cm6(text):
    """Decode a CM6 character stream into an int64 array."""

    values = []
    av = 0
    sign = 1
    in_value = False
    for ch in text:
        if ch in "\r\n \t":
            continue
        try:
            c = _CHAR_TO_VAL[ch]
        except KeyError:
            raise ValueError(
                f"Invalid CM6 character {ch!r} in GSE2 data section."
            ) from None
        if not in_value:
            sign = -1 if c & _SIGN else 1
            av = c & 0x0F
            in_value = bool(c & _CONTINUATION)
        else:
            av = (av << 5) | (c & 0x1F)
            in_value = bool(c & _CONTINUATION)
        if not in_value:
            values.append(sign * av)
    return np.asarray(values, dtype=np.int64)


def write_gse2(stream, filename):
    """Write a Stream as GSE2.0/CM6, one WID2 block per trace."""

    from .utcdatetime import UTCDateTime

    lines = []
    for tr in stream:
        stats = tr.stats
        # Round to the WID2 field's millisecond resolution BEFORE reading
        # components: formatting 59.9996 s as %06.3f would write the
        # unparseable "60.000"
        t = UTCDateTime(ns=int(round(stats.starttime.ns / 1e6)) * 1_000_000)
        data = np.asarray(tr.data)
        if not np.issubdtype(data.dtype, np.integer):
            rounded = np.rint(data)
            if not np.allclose(data, rounded, atol=1e-6):
                raise ValueError(
                    "GSE2/CM6 stores integer counts; trace data must be "
                    "integer-valued (got non-integral floats)."
                )
            data = rounded
        data = data.astype(np.int64)

        date = f"{t.year:04d}/{t.month:02d}/{t.day:02d}"
        time = (
            f"{t.hour:02d}:{t.minute:02d}:"
            f"{t.second + t.microsecond / 1e6:06.3f}"
        )
        lines.append(
            f"WID2 {date} {time} {stats.station:<5s} {stats.channel:<3s} "
            f"{'':<4s} CM6 {data.size:8d} {stats.sampling_rate:11.6f} "
            f"{1.0:10.2e} {1.0:7.3f} {'':<6s} {-1.0:5.1f} {-1.0:4.1f}"
        )
        lines.append("DAT2")
        encoded = _encode_cm6(_second_differences(data))
        for i in range(0, len(encoded), 80):
            lines.append(encoded[i : i + 80])
        lines.append(f"CHK2 {_checksum(data):8d}")
        lines.append("")

    with open(filename, "w") as f:
        f.write("\n".join(lines))


def read_gse2(filename):
    """Read a GSE2.0/CM6 file into a Stream."""

    from .trace import Stream, Trace
    from .utcdatetime import UTCDateTime

    with open(filename) as f:
        content = f.read()

    traces = []
    blocks = content.split("WID2 ")[1:]
    for block in blocks:
        lines = block.splitlines()
        if not lines:
            # e.g. a file ENDING with the "WID2 " delimiter
            raise ValueError("Empty GSE2 WID2 block.")
        head = lines[0].split()
        if len(head) < 4:
            raise ValueError(
                f"Malformed GSE2 WID2 line: {lines[0][:80]!r}"
            )
        date, time, station, channel = head[0], head[1], head[2], head[3]
        # The sub-format token sits before the sample count; auxid may be
        # blank (collapsed by split), so locate "CM6" explicitly
        fmt_idx = next(
            (i for i, tok in enumerate(head) if tok in ("CM6", "INT", "CM8")),
            None,
        )
        if fmt_idx is None:
            raise ValueError(
                "GSE2 WID2 line carries no recognised sub-format token."
            )
        if head[fmt_idx] != "CM6":
            raise NotImplementedError(
                f"GSE2 sub-format {head[fmt_idx]} not supported (only CM6)"
            )
        if fmt_idx + 2 >= len(head):
            raise ValueError("Truncated GSE2 WID2 line.")
        npts = int(head[fmt_idx + 1])
        sampling_rate = float(head[fmt_idx + 2])
        if npts < 0:
            raise ValueError(f"GSE2 WID2 claims negative samples: {npts}.")
        if not np.isfinite(sampling_rate) or sampling_rate <= 0:
            raise ValueError(
                f"GSE2 WID2 has invalid sampling rate {sampling_rate}."
            )

        dat_start = next(
            (i for i, ln in enumerate(lines) if ln.startswith("DAT2")), None
        )
        if dat_start is None:
            raise ValueError("GSE2 block has no DAT2 data section.")
        data_chars = []
        chk = None
        for ln in lines[dat_start + 1 :]:
            if ln.startswith("CHK2"):
                fields = ln.split()
                if len(fields) < 2:
                    raise ValueError("Malformed GSE2 CHK2 line.")
                chk = int(fields[1])
                break
            data_chars.append(ln.strip())
        diffs = _decode_cm6("".join(data_chars))
        data = _integrate_twice(diffs)[:npts].astype(np.int32)

        if chk is not None:
            got = _checksum(data)
            if got != chk:
                raise ValueError(
                    f"GSE2 checksum mismatch: file says {chk}, data gives "
                    f"{got}"
                )

        traces.append(
            Trace(
                data,
                {
                    "station": station,
                    "channel": channel,
                    "sampling_rate": sampling_rate,
                    "starttime": UTCDateTime(f"{date.replace('/', '-')}T{time}"),
                },
            )
        )

    return Stream(traces)
