# -*- coding: utf-8 -*-
"""
SEG-Y rev 1 waveform I/O (IEEE float32, big-endian), after the JAX
package's ``seis/segy.py``.

The reference writes cut waveforms in SEGY via ObsPy
(reference: io/cut_waveforms.py:44-213, format string "SEGY"); this is a
native minimal implementation: 3200-byte textual header, 400-byte binary
file header, and per-trace 240-byte headers with data sample format 5
(4-byte IEEE float). SEG-Y's 16-bit header fields cap traces at 65535
samples and the sample interval at 65535 microseconds (>= ~15.26 Hz), the
same limits ObsPy enforces.

SEG-Y's trace header has no field for a seismic channel's id, so the port
also writes each trace's ``NET.STA.LOC.CHA`` into the free-form textual
header, one card a trace from card 3 (``C 3 TRACE    1 SC.STA..CHZ``), for
the first :data:`ID_CARDS` traces, and reads it back where it finds it: so
an archive of SEG-Y files can be scanned. Apart from those cards and card
2's writer name, the port writes the JAX package's bytes; the JAX
package's reader ignores the cards.

"""

import re
import struct

import numpy as np

# Textual-header cards 3-39 hold the ids of the first 37 traces
ID_CARDS = 37
_ID_CARD = re.compile(r"C\s*\d+ TRACE\s+(\d+) (\S*)")


def write_segy(stream, filename):
    """Write a Stream as SEG-Y rev 1 (IEEE float32)."""

    for tr in stream:
        if tr.stats.npts > 65535:
            raise ValueError(
                f"SEGY traces cap at 65535 samples; {tr.id} has "
                f"{tr.stats.npts}. Split the stream or use MSEED."
            )
        dt_us = 1e6 / tr.stats.sampling_rate
        if not 1 <= round(dt_us) <= 65535:
            raise ValueError(
                f"SEGY sample interval must be 1-65535 microseconds; "
                f"{tr.id} has {dt_us:.1f}."
            )

    with open(filename, "wb") as f:
        # Textual header: 40 cards x 80 chars, ASCII
        cards = [
            "C 1 SEG Y REV1".ljust(80),
            "C 2 WRITTEN BY QUAKEMIGRATE_TORCH".ljust(80),
        ]
        cards += [
            (f"C{i + 3:2d} TRACE {i + 1:4d} {stream[i].id}" if i < len(stream)
             else f"C{i + 3:2d}")[:80].ljust(80)
            for i in range(ID_CARDS)
        ]
        cards.append("C40 END TEXTUAL HEADER".ljust(80))
        f.write("".join(cards).encode("ascii"))

        first = stream[0].stats
        dt_us = int(round(1e6 / first.sampling_rate))
        binary = bytearray(400)
        # Unsigned: dt_us is validated to 1-65535, which overflows ">h"
        # for rates below ~30.5 Hz (e.g. 20 Hz -> 50000 us)
        struct.pack_into(">H", binary, 16, dt_us)  # bytes 3217-3218
        struct.pack_into(">H", binary, 20, min(first.npts, 65535))
        struct.pack_into(">h", binary, 24, 5)  # format 5 = IEEE float32
        struct.pack_into(">h", binary, 300, 256)  # rev 1.0 (0x0100)
        struct.pack_into(">h", binary, 302, 1)  # fixed-length traces flag
        f.write(bytes(binary))

        for i, tr in enumerate(stream):
            stats = tr.stats
            t = stats.starttime
            header = bytearray(240)
            struct.pack_into(">i", header, 0, i + 1)  # trace sequence no.
            struct.pack_into(">h", header, 28, 1)  # trace id: seismic data
            struct.pack_into(">H", header, 114, stats.npts)
            struct.pack_into(
                ">H", header, 116, int(round(1e6 / stats.sampling_rate))
            )
            struct.pack_into(">h", header, 156, t.year)
            struct.pack_into(">h", header, 158, t.julday)
            struct.pack_into(">h", header, 160, t.hour)
            struct.pack_into(">h", header, 162, t.minute)
            struct.pack_into(">h", header, 164, t.second)
            struct.pack_into(">h", header, 166, 1)  # time basis: local/UTC
            # SEG-Y has no standard sub-second field; stash the microsecond
            # remainder in the unassigned bytes 233-236 so our own reader
            # roundtrips losslessly (other readers ignore unassigned bytes)
            struct.pack_into(">i", header, 232, t.microsecond)
            f.write(bytes(header))
            f.write(
                np.asarray(tr.data, dtype=">f4").tobytes()
            )


def read_segy(filename):
    """Read a SEG-Y rev 1 file (IEEE float32 traces) into a Stream."""

    from .trace import Stream, Trace
    from .utcdatetime import UTCDateTime

    with open(filename, "rb") as f:
        raw = f.read()

    if len(raw) < 3600:
        raise ValueError(
            f"File too short for SEGY: {len(raw)} bytes < 3600-byte header."
        )
    ids = {}
    for c in range(2, 2 + ID_CARDS):
        m = _ID_CARD.match(raw[80 * c:80 * (c + 1)].decode("ascii", "replace"))
        if m:
            ids[int(m.group(1))] = m.group(2)
    binary = raw[3200:3600]
    fmt = struct.unpack_from(">h", binary, 24)[0]
    if fmt != 5:
        raise NotImplementedError(
            f"SEGY data sample format {fmt} not supported (only 5 = IEEE "
            "float32)"
        )

    traces = []
    pos = 3600
    while pos + 240 <= len(raw):
        header = raw[pos : pos + 240]
        npts = struct.unpack_from(">H", header, 114)[0]
        dt_us = struct.unpack_from(">H", header, 116)[0]
        year = struct.unpack_from(">h", header, 156)[0]
        jday = struct.unpack_from(">h", header, 158)[0]
        hour = struct.unpack_from(">h", header, 160)[0]
        minute = struct.unpack_from(">h", header, 162)[0]
        second = struct.unpack_from(">h", header, 164)[0]
        microsecond = struct.unpack_from(">i", header, 232)[0]
        if not 0 <= microsecond < 1_000_000:
            microsecond = 0  # foreign file using the unassigned bytes
        pos += 240
        if pos + 4 * npts > len(raw):
            raise ValueError(
                f"Truncated SEGY trace: header claims {npts} samples but "
                f"only {(len(raw) - pos) // 4} remain."
            )
        data = np.frombuffer(raw[pos : pos + 4 * npts], dtype=">f4").astype(
            np.float32
        )
        pos += 4 * npts

        stats = {"sampling_rate": 1e6 / dt_us if dt_us else 1.0}
        seed_id = ids.get(len(traces) + 1, "").split(".")
        if len(seed_id) == 4:
            stats.update(zip(("network", "station", "location", "channel"),
                             seed_id))
        if year > 0:
            stats["starttime"] = UTCDateTime(
                year=year, julday=jday, hour=hour, minute=minute,
                second=second, microsecond=microsecond,
            )
        traces.append(Trace(data, stats))

    return Stream(traces)
