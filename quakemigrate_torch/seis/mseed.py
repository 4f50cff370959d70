# -*- coding: utf-8 -*-
"""
miniSEED (SEED v2.4 data record) reader and writer.

Supports the encodings the pipeline needs: STEIM1 (10), STEIM2 (11), INT16
(1), INT32 (3), FLOAT32 (4) and FLOAT64 (5), big- or little-endian headers,
and 256-8192 byte records. A copy of the JAX package's ``seis/mseed.py``;
the STEIM codecs are the port's own C codec (``seis/steim.py``, built with
the host C compiler at first use).

The writer produces big-endian records with a Blockette 1000 (and a
Blockette 1001 carrying the microsecond remainder when the record start time
does not fall on a 100-microsecond boundary).

"""

from __future__ import annotations

import logging
import struct
from datetime import date as _date
from functools import lru_cache

import numpy as np

from .steim import (  # noqa: F401 (steim_encode is part of the surface)
    steim_decode,
    steim_decode_records,
    steim_encode,
    steim_encode_records,
)
from .trace import Stream, Trace
from .utcdatetime import UTCDateTime

_NS = 1_000_000_000
_EPOCH_ORDINAL = _date(1970, 1, 1).toordinal()


@lru_cache(maxsize=64)
def _year_start_ns(year):
    return (_date(year, 1, 1).toordinal() - _EPOCH_ORDINAL) * 86400 * _NS

_ENCODING_DTYPES = {
    1: ("i2", 2),
    3: ("i4", 4),
    4: ("f4", 4),
    5: ("f8", 8),
}


class MSEEDError(Exception):
    """Raised for malformed or unsupported miniSEED content."""


def _parse_btime(buf, offset, endian):
    year, jday, hour, minute, sec, _, tmilli = struct.unpack_from(
        endian + "HHBBBBH", buf, offset
    )
    return year, jday, hour, minute, sec, tmilli


def _detect_endian(buf, offset):
    """SEED headers carry no endian flag; sniff via the year field."""

    for endian in (">", "<"):
        year, jday = struct.unpack_from(endian + "HH", buf, offset + 20)
        if 1900 <= year <= 2100 and 1 <= jday <= 366:
            return endian
    raise MSEEDError("Cannot determine miniSEED byte order.")


def _read_record_header(buf, offset):
    endian = _detect_endian(buf, offset)
    (
        station,
        location,
        channel,
        network,
    ) = (
        buf[offset + 8 : offset + 13].decode("ascii", "replace").strip(),
        buf[offset + 13 : offset + 15].decode("ascii", "replace").strip(),
        buf[offset + 15 : offset + 18].decode("ascii", "replace").strip(),
        buf[offset + 18 : offset + 20].decode("ascii", "replace").strip(),
    )
    year, jday, hour, minute, sec, tmilli = _parse_btime(buf, offset + 20, endian)
    npts, srfactor, srmult = struct.unpack_from(endian + "Hhh", buf, offset + 30)
    act_flags, _, _, nblockettes = struct.unpack_from("BBBB", buf, offset + 36)
    (time_corr,) = struct.unpack_from(endian + "i", buf, offset + 40)
    data_offset, blockette_offset = struct.unpack_from(endian + "HH", buf, offset + 44)

    # Walk the blockette chain for 1000 (encoding/reclen) and 1001 (usec)
    encoding, reclen, word_order, usec = None, None, 1, 0
    boff = blockette_offset
    for _ in range(nblockettes):
        if boff == 0 or boff + 4 > len(buf) - offset:
            break
        btype, next_off = struct.unpack_from(endian + "HH", buf, offset + boff)
        if btype == 1000:
            enc, wo, rl = struct.unpack_from("BBB", buf, offset + boff + 4)
            encoding, word_order, reclen = enc, wo, 2**rl
        elif btype == 1001:
            _, us = struct.unpack_from("Bb", buf, offset + boff + 4)
            usec = us
        if next_off == 0:
            break
        boff = next_off

    if encoding is None:
        raise MSEEDError("miniSEED record without Blockette 1000 unsupported.")

    if srfactor > 0 and srmult > 0:
        sampling_rate = srfactor * srmult
    elif srfactor > 0 > srmult:
        sampling_rate = -srfactor / srmult
    elif srfactor < 0 < srmult:
        sampling_rate = -srmult / srfactor
    elif srfactor < 0 and srmult < 0:
        sampling_rate = 1.0 / (srfactor * srmult)
    else:
        sampling_rate = 1.0
    # Corrupt factor/multiplier pairs can yield rates so small the
    # record's time span overflows int64 nanoseconds downstream (fuzz
    # finding). A data record claiming to span more than ~a year is
    # garbage regardless.
    if sampling_rate <= 0 or npts / sampling_rate > 366 * 86400:
        raise MSEEDError(
            f"Implausible sampling rate {sampling_rate} for {npts} samples."
        )

    # Integer-nanosecond record start (hot path: avoid building UTCDateTime
    # objects per record; files can hold hundreds of thousands of records)
    start_ns = (
        _year_start_ns(year)
        + ((jday - 1) * 86400 + hour * 3600 + minute * 60 + sec) * _NS
        + tmilli * 100_000
        + usec * 1000
    )
    if time_corr and not (act_flags & 0x02):
        start_ns += time_corr * 100_000

    return {
        "endian": endian,
        "station": station,
        "location": location,
        "channel": channel,
        "network": network,
        "starttime_ns": start_ns,
        "npts": npts,
        "sampling_rate": sampling_rate,
        "encoding": encoding,
        "word_order": word_order,
        "reclen": reclen,
        "data_offset": data_offset,
    }


def _decode_record(buf, offset, hdr):
    npts = hdr["npts"]
    payload = buf[offset + hdr["data_offset"] : offset + hdr["reclen"]]
    enc = hdr["encoding"]
    if enc in (10, 11):
        return steim_decode(
            payload, npts, enc,
            little_endian=hdr["word_order"] == 0,
        )
    if enc in _ENCODING_DTYPES:
        code, size = _ENCODING_DTYPES[enc]
        if npts * size > len(payload):
            # Claimed sample count exceeds the record's payload: corrupt
            # header. Skip the record (the indexed fast path defers
            # exactly this class of file to this walk on that promise).
            logging.info(
                "Skipping corrupt miniSEED record: claimed npts %d "
                "exceeds payload capacity %d", npts, len(payload) // size,
            )
            return None
        endian = ">" if hdr["word_order"] == 1 else "<"
        return np.frombuffer(payload[: npts * size], dtype=endian + code).copy()
    if enc == 0:  # ASCII log record -- skip
        return None
    raise MSEEDError(f"Unsupported miniSEED encoding: {enc}")


# Per-file record index: (mtime_ns, size) -> int64 arrays of the data
# records' byte offsets and time spans. A detect run reads consecutive
# windows from the same day files, so after the first read only the
# records inside each window need their headers parsed (files can hold
# tens of thousands of records; the header walk dominates repeat reads).
_INDEX_CACHE = {}
_INDEX_CACHE_MAX = 128


def _file_index(path, stat_key):
    key = str(path)
    cached = _INDEX_CACHE.get(key)
    if cached is not None and cached[0] == stat_key:
        # LRU: refresh recency so cycling through >max files per window
        # does not evict the whole working set every pass. pop() is
        # guarded: a concurrent reader thread may have evicted the
        # entry between the get and the pop.
        _INDEX_CACHE.pop(key, None)
        _INDEX_CACHE[key] = cached
        return cached[1]
    return None


def _store_index(path, stat_key, offsets, starts, ends, halves):
    """Cache the record index keyed by the stat snapshot taken from the
    OPEN handle before the content was read -- stat-ing the path again
    here would let a concurrent append make a stale index look fresh."""

    while len(_INDEX_CACHE) >= _INDEX_CACHE_MAX:
        try:
            # Guarded like _file_index's pop: a concurrent reader thread
            # may have evicted the same oldest entry already.
            _INDEX_CACHE.pop(next(iter(_INDEX_CACHE)), None)
        except StopIteration:  # emptied concurrently
            break
    _INDEX_CACHE[str(path)] = (
        stat_key,
        (
            np.asarray(offsets, dtype=np.int64),
            np.asarray(starts, dtype=np.int64),
            np.asarray(ends, dtype=np.int64),
            np.asarray(halves, dtype=np.int64),
        ),
    )


def _try_uniform_walk(buf):
    """
    Vectorised record walk for uniform files -- the overwhelmingly common
    case this framework both writes and reads: ONE channel per file, a
    fixed record length, constant sampling rate and layout, blockette
    1000 at a fixed offset (per-record STEIM1 fallbacks inside a STEIM2
    file are allowed). Parses every header field with numpy column views
    instead of a per-record Python loop (which dominated day-file reads:
    ~13 us x hundreds of thousands of records).

    Returns (hdr0, offsets, start_ns, npts, enc) as int64/uint8 arrays,
    or None whenever ANY record deviates from the uniform layout -- the
    caller then takes the general per-record walk, which handles
    multiplexed, mixed-rate, resynced and corrupt files.

    """

    if len(buf) < 128:
        return None
    try:
        hdr0 = _read_record_header(buf, 0)
    except (MSEEDError, struct.error):
        return None
    reclen = hdr0["reclen"]
    n, rem = divmod(len(buf), reclen)
    if rem or n < 2 or reclen < 64:
        return None
    arr = np.frombuffer(buf, np.uint8).reshape(n, reclen)
    endian = hdr0["endian"]

    def col(off, dtype):
        width = np.dtype(dtype).itemsize
        return (
            arr[:, off : off + width]
            .copy()
            .view(endian + dtype if dtype != "u1" else dtype)
            .ravel()
        )

    # Every record must be a data record of the same layout; multiple
    # SEED ids are allowed (multiplexed files, e.g. the five-channel
    # .scanmseed day files) -- records group by id below.
    if not np.isin(arr[:, 6], (ord("D"), ord("R"), ord("Q"), ord("M"))).all():
        return None
    ids, id_inverse = np.unique(arr[:, 8:20], axis=0, return_inverse=True)
    if len(ids) > 64:
        return None  # implausible id count: likely corrupt headers
    if (col(32, "i2") != col(32, "i2")[0]).any():
        return None
    if (col(34, "i2") != col(34, "i2")[0]).any():
        return None
    if (col(44, "u2") != hdr0["data_offset"]).any():
        return None
    boffs = col(46, "u2")
    b0 = int(boffs[0])
    if b0 == 0 or b0 + 8 > reclen or (boffs != b0).any():
        return None
    # Blockette 1000 at the fixed offset in every record.
    if (col(b0, "u2") != 1000).any():
        return None
    nexts = col(b0 + 2, "u2")
    has_1001 = nexts == b0 + 8
    if not (has_1001 | (nexts == 0)).all():
        return None
    enc = arr[:, b0 + 4].copy()
    if (arr[:, b0 + 5] != hdr0["word_order"]).any():
        return None
    if (arr[:, b0 + 6] != int(np.log2(reclen))).any():
        return None
    usec = np.zeros(n, dtype=np.int64)
    if has_1001.any():
        if b0 + 16 > reclen:
            return None
        if (col(b0 + 8, "u2")[has_1001] != 1001).any():
            return None
        usec[has_1001] = arr[:, b0 + 13].view(np.int8)[has_1001]

    year = col(20, "u2")
    jday = col(22, "u2")
    if not (
        (year >= 1900) & (year <= 2100) & (jday >= 1) & (jday <= 366)
    ).all():
        return None
    sr = hdr0["sampling_rate"]

    years_ns = np.zeros(n, dtype=np.int64)
    for y in np.unique(year):
        years_ns[year == y] = _year_start_ns(int(y))
    start_ns = (
        years_ns
        + (
            (jday.astype(np.int64) - 1) * 86400
            + arr[:, 24].astype(np.int64) * 3600
            + arr[:, 25].astype(np.int64) * 60
            + arr[:, 26].astype(np.int64)
        )
        * _NS
        + col(28, "u2").astype(np.int64) * 100_000
        + usec * 1000
    )
    time_corr = col(40, "i4").astype(np.int64)
    unapplied = (arr[:, 36] & 0x02) == 0
    start_ns += np.where(unapplied, time_corr * 100_000, 0)

    npts = col(30, "u2").astype(np.int64)
    # The hdr0 sanity guard, applied to the widest record.
    if sr <= 0 or int(npts.max()) / sr > 366 * 86400:
        return None
    return (
        hdr0, np.arange(n, dtype=np.int64) * reclen, start_ns, npts, enc,
        ids, id_inverse,
    )


def _uniform_read(buf, path, hdr0, offsets, start_ns, npts, enc, ids,
                  id_inverse, start_q, end_q, starttime, endtime,
                  nearest_sample, stat_key):
    """Decode + segment a uniform file from vectorised walk output, one
    native batch-decode call per SEED id for STEIM payloads."""

    sr = hdr0["sampling_rate"]
    half_ns = round(0.5 / sr * _NS)
    end_ns = start_ns + np.round((npts - 1) / sr * _NS).astype(np.int64)

    live = (npts > 0) & (enc != 0)
    _store_index(path, stat_key, offsets[live], start_ns[live],
                 end_ns[live], np.full(int(live.sum()), half_ns))

    sel = live.copy()
    if start_q is not None:
        sel &= end_ns >= start_q - half_ns
    if end_q is not None:
        sel &= start_ns <= end_q + half_ns

    tol = half_ns  # same half-sample slack as the window selection
    segments = {}
    for c in range(len(ids)):
        idx = np.flatnonzero(sel & (id_inverse == c))
        if idx.size == 0:
            continue
        enc_sel = enc[idx]
        if np.isin(enc_sel, (10, 11)).all():
            data = steim_decode_records(
                buf, offsets[idx], npts[idx], enc_sel, hdr0["data_offset"],
                hdr0["reclen"], little_endian=hdr0["word_order"] == 0,
            )
        elif (
            (enc_sel == enc_sel[0]).all()
            and int(enc_sel[0]) in _ENCODING_DTYPES
        ):
            # A record claiming more samples than its payload can hold
            # would silently under-produce here while the segment edges
            # below assume the claimed npts -- misattributing later
            # samples (review finding). Decline; the general walk logs
            # and skips such records.
            _, size = _ENCODING_DTYPES[int(enc_sel[0])]
            capacity = (hdr0["reclen"] - hdr0["data_offset"]) // size
            if int(npts[idx].max()) > capacity:
                return None
            chunks = []
            for r in idx:
                hdr_r = dict(hdr0, npts=int(npts[r]), encoding=int(enc[r]))
                chunks.append(_decode_record(buf, int(offsets[r]), hdr_r))
            data = np.concatenate(chunks)
        else:
            return None  # mixed/unknown encodings: take the general walk

        # Segment at continuity breaks among the SELECTED records
        # (skipped out-of-window records break contiguity exactly as in
        # the general walk: the next record's start will not match the
        # expected continuation time).
        expected = start_ns[idx][:-1] + np.round(
            npts[idx][:-1] / sr * _NS
        ).astype(np.int64)
        breaks = np.flatnonzero(
            np.abs(start_ns[idx][1:] - expected) >= tol
        ) + 1
        bounds = np.concatenate([[0], breaks, [idx.size]])
        sample_edges = np.concatenate([[0], np.cumsum(npts[idx])])

        raw = bytes(ids[c])
        key = (
            raw[10:12].decode("ascii", "replace").strip(),  # network
            raw[0:5].decode("ascii", "replace").strip(),    # station
            raw[5:7].decode("ascii", "replace").strip(),    # location
            raw[7:10].decode("ascii", "replace").strip(),   # channel
        )
        seglist = segments.setdefault(key, [])
        for a, b in zip(bounds[:-1], bounds[1:]):
            chunk = data[sample_edges[a] : sample_edges[b]]
            seglist.append(
                {"start_ns": int(start_ns[idx[a]]), "sr": sr,
                 "chunks": [chunk], "n": len(chunk)}
            )
    return _segments_to_stream(
        segments, starttime, endtime, nearest_sample
    )


def read_mseed(path, starttime=None, endtime=None, nearest_sample=True):
    """
    Read a miniSEED file into a Stream. Records are grouped by SEED id and
    joined into continuous traces; gaps/overlaps start new traces. If a time
    window is given, record decoding is skipped entirely for records outside
    the window, and a per-file record index (built on the first read) lets
    repeat reads of the same file skip the header walk too.

    """

    import os

    start_ns = None if starttime is None else UTCDateTime(starttime).ns
    end_ns = None if endtime is None else UTCDateTime(endtime).ns

    with open(path, "rb") as f:
        st = os.fstat(f.fileno())
        stat_key = (st.st_mtime_ns, st.st_size)

        index = _file_index(path, stat_key)
        if index is not None:
            # Windowed + indexed: read ONLY the byte span covering the
            # in-window records instead of the whole file. Day-long
            # archive files make this the detect hot path: a 120 s
            # window touches ~1% of a 250 Hz day file, and re-reading
            # the full file every window made file I/O dominate the
            # whole pipeline (measured: 816 MB of page-cache reads per
            # window across a 24-file day archive).
            offsets, starts, ends, halves = index
            mask = np.ones(offsets.shape, dtype=bool)
            if start_ns is not None:
                mask &= ends >= start_ns - halves
            if end_ns is not None:
                mask &= starts <= end_ns + halves
            sel = np.flatnonzero(mask)
            if sel.size == 0:
                return Stream()
            lo = int(offsets[sel[0]])
            last = int(sel[-1])
            hi = (
                int(offsets[last + 1])
                if last + 1 < len(offsets)
                else st.st_size
            )
            f.seek(lo)
            buf = f.read(hi - lo)
            return _read_indexed(
                path, buf, lo,
                (offsets[sel], starts[sel], ends[sel], halves[sel]),
                None, None, starttime, endtime, nearest_sample,
            )

        # Unindexed (first read of the file) or full-file read: fall
        # through to the record walk below, which builds the index.
        buf = f.read()

    # Uniform-file fast path: vectorised header walk + one native batch
    # decode. Any layout deviation or decode failure falls back to the
    # general per-record walk below.
    uniform = _try_uniform_walk(buf)
    if uniform is not None:
        try:
            stream = _uniform_read(
                buf, path, *uniform, start_ns, end_ns, starttime, endtime,
                nearest_sample, stat_key,
            )
        except ValueError:
            stream = None  # a record under-produced: general walk logs it
        if stream is not None:
            return stream
        _INDEX_CACHE.pop(str(path), None)

    idx_offsets, idx_starts, idx_ends, idx_halves = [], [], [], []
    walk_complete = True
    segments = {}  # seed id -> list of segment dicts (integer-ns times)
    offset = 0
    while offset + 48 <= len(buf):
        try:
            hdr = _read_record_header(buf, offset)
        except (MSEEDError, struct.error):
            # Possibly a non-data record; skip 64 bytes and resync
            offset += 64
            continue
        reclen = hdr["reclen"]
        if offset + reclen > len(buf):
            logging.info(
                f"Skipping truncated miniSEED record at offset {offset} in {path}."
            )
            walk_complete = False
            break
        if hdr["npts"] > 0 and hdr["encoding"] != 0:
            sr = hdr["sampling_rate"]
            half_ns = round(0.5 / sr * _NS)
            rec_start_ns = hdr["starttime_ns"]
            rec_end_ns = rec_start_ns + round((hdr["npts"] - 1) / sr * _NS)
            idx_offsets.append(offset)
            idx_starts.append(rec_start_ns)
            idx_ends.append(rec_end_ns)
            idx_halves.append(half_ns)
            # Half-sample slack: with nearest_sample=True the window
            # bound can snap to a sample just outside [start, end]
            skip = (
                start_ns is not None and rec_end_ns < start_ns - half_ns
            ) or (
                end_ns is not None and rec_start_ns > end_ns + half_ns
            )
            if not skip:
                try:
                    data = _decode_record(buf, offset, hdr)
                except (MSEEDError, ValueError) as exc:
                    logging.info(
                        f"Skipping unreadable miniSEED record at offset "
                        f"{offset} in {path}: {exc}"
                    )
                    data = None
                if data is not None:
                    key = (
                        hdr["network"],
                        hdr["station"],
                        hdr["location"],
                        hdr["channel"],
                    )
                    seglist = segments.setdefault(key, [])
                    tol_ns = round(0.5 / sr * _NS)
                    if seglist:
                        last = seglist[-1]
                        expected_ns = last["start_ns"] + round(
                            last["n"] / sr * _NS
                        )
                        if (
                            abs(rec_start_ns - expected_ns) < tol_ns
                            and last["sr"] == sr
                            and last["chunks"][-1].dtype == data.dtype
                        ):
                            last["chunks"].append(data)
                            last["n"] += len(data)
                        else:
                            seglist.append(
                                {"start_ns": rec_start_ns, "sr": sr,
                                 "chunks": [data], "n": len(data)}
                            )
                    else:
                        seglist.append(
                            {"start_ns": rec_start_ns, "sr": sr,
                             "chunks": [data], "n": len(data)}
                        )
        offset += reclen

    if walk_complete:
        # A truncated walk must NOT be cached: caching it would silently
        # hide the unparsed tail from every later read of the file
        _store_index(path, stat_key, idx_offsets, idx_starts, idx_ends,
                     idx_halves)
    return _segments_to_stream(segments, starttime, endtime, nearest_sample)


def _read_indexed(
    path, buf, base, index, start_ns, end_ns, starttime, endtime,
    nearest_sample,
):
    """Read only the in-window records using a cached file index.
    ``buf`` holds the file content from byte ``base`` onward (the caller
    may have read just the relevant span)."""

    offsets, starts, ends, halves = index
    mask = np.ones(offsets.shape, dtype=bool)
    if start_ns is not None:
        mask &= ends >= start_ns - halves
    if end_ns is not None:
        mask &= starts <= end_ns + halves

    segments = {}
    for offset in offsets[mask]:
        offset = int(offset) - base
        try:
            hdr = _read_record_header(buf, offset)
        except (MSEEDError, struct.error):
            continue
        sr = hdr["sampling_rate"]
        rec_start_ns = hdr["starttime_ns"]
        try:
            data = _decode_record(buf, offset, hdr)
        except (MSEEDError, ValueError) as exc:
            logging.info(
                f"Skipping unreadable miniSEED record at offset "
                f"{offset} in {path}: {exc}"
            )
            continue
        key = (hdr["network"], hdr["station"], hdr["location"],
               hdr["channel"])
        seglist = segments.setdefault(key, [])
        tol_ns = round(0.5 / sr * _NS)
        if seglist:
            last = seglist[-1]
            expected_ns = last["start_ns"] + round(last["n"] / sr * _NS)
            if (
                abs(rec_start_ns - expected_ns) < tol_ns
                and last["sr"] == sr
                and last["chunks"][-1].dtype == data.dtype
            ):
                last["chunks"].append(data)
                last["n"] += len(data)
                continue
        seglist.append(
            {"start_ns": rec_start_ns, "sr": sr, "chunks": [data],
             "n": len(data)}
        )

    return _segments_to_stream(segments, starttime, endtime, nearest_sample)


def _segments_to_stream(segments, starttime, endtime, nearest_sample):
    stream = Stream()
    for (net, sta, loc, cha), seglist in sorted(segments.items()):
        for seg in seglist:
            tr = Trace(
                np.concatenate(seg["chunks"]),
                {
                    "network": net,
                    "station": sta,
                    "location": loc,
                    "channel": cha,
                    "starttime": UTCDateTime(ns=seg["start_ns"]),
                    "sampling_rate": seg["sr"],
                },
            )
            if starttime is not None or endtime is not None:
                tr.trim(
                    starttime=starttime,
                    endtime=endtime,
                    nearest_sample=nearest_sample,
                )
            if bool(tr):
                stream += tr
    return stream


def _sr_factor_mult(sr):
    if sr <= 0:
        raise MSEEDError(f"Cannot encode sampling rate {sr} in SEED header.")
    if sr >= 1:
        if abs(sr - round(sr)) < 1e-9:
            sr_int = int(round(sr))
            if sr_int <= 32767:
                return sr_int, 1
            # Rates beyond the signed-short field encode as
            # factor * multiplier (e.g. 40 kHz = 200 * 200).
            for mult in range(2, 32768):
                if sr_int % mult == 0 and sr_int // mult <= 32767:
                    return sr_int // mult, mult
            raise MSEEDError(
                f"Cannot encode sampling rate {sr} in SEED header."
            )
        # Try rational representation sr = factor / -mult
        for mult in range(2, 1000):
            if abs(sr * mult - round(sr * mult)) < 1e-9:
                return int(round(sr * mult)), -mult
    else:
        period = 1.0 / sr
        if abs(period - round(period)) < 1e-9:
            return -int(round(period)), 1
    raise MSEEDError(f"Cannot encode sampling rate {sr} in SEED header.")


def _build_header(stats, rec_start, npts, encoding, reclen_power, seqnum):
    dt = rec_start
    tmilli_total = dt.nanosecond // 100_000  # 0.1 ms units
    usec_rem = (dt.nanosecond // 1000) % 100  # microsecond remainder
    srfactor, srmult = _sr_factor_mult(stats.sampling_rate)

    header = bytearray(64)
    header[0:6] = f"{seqnum % 1000000:06d}".encode()
    header[6:7] = b"D"
    header[7:8] = b" "
    header[8:13] = f"{stats.station[:5]:<5s}".encode()
    header[13:15] = f"{stats.location[:2]:<2s}".encode()
    header[15:18] = f"{stats.channel[:3]:<3s}".encode()
    header[18:20] = f"{stats.network[:2]:<2s}".encode()
    struct.pack_into(
        ">HHBBBBH",
        header,
        20,
        dt.year,
        dt.julday,
        dt.hour,
        dt.minute,
        dt.second,
        0,
        tmilli_total % 10000,
    )
    struct.pack_into(">Hhh", header, 30, npts, srfactor, srmult)
    n_blockettes = 2 if usec_rem else 1
    struct.pack_into("BBBB", header, 36, 0, 0, 0, n_blockettes)
    struct.pack_into(">i", header, 40, 0)
    struct.pack_into(">HH", header, 44, 64, 48)
    # Blockette 1000
    next_blockette = 56 if usec_rem else 0
    struct.pack_into(">HH", header, 48, 1000, next_blockette)
    struct.pack_into("BBBB", header, 52, encoding, 1, reclen_power, 0)
    if usec_rem:
        struct.pack_into(">HH", header, 56, 1001, 0)
        struct.pack_into("BbBB", header, 60, 0, usec_rem, 0, 0)
    return bytes(header)


def write_mseed(stream, path, encoding=None, reclen=512):
    """
    Write a Stream to a miniSEED file.

    ``encoding`` may be "STEIM2", "STEIM1", "INT32", "FLOAT32", "FLOAT64" or
    the corresponding SEED integer codes; by default integer data is written
    as STEIM2 and float data as FLOAT64. STEIM2 encoding falls back to
    STEIM1 automatically if a difference overflows 30 bits.

    """

    names = {"STEIM1": 10, "STEIM2": 11, "INT16": 1, "INT32": 3,
             "FLOAT32": 4, "FLOAT64": 5}
    if isinstance(encoding, str):
        if encoding.upper() not in names:
            raise MSEEDError(f"Unsupported miniSEED encoding: {encoding}")
        encoding = names[encoding.upper()]
    elif encoding is not None and encoding not in names.values():
        raise MSEEDError(f"Unsupported miniSEED encoding code: {encoding}")

    reclen_power = int(np.log2(reclen))
    if 2**reclen_power != reclen:
        raise ValueError("Record length must be a power of two.")
    if reclen < 128:
        # 64 bytes are the header: a 64-byte record holds no data, which
        # the packing loops cannot make progress on
        raise ValueError("Record length must be at least 128 bytes.")
    nframes = (reclen - 64) // 64

    out = bytearray()
    seqnum = 1
    for tr in stream:
        data = np.asarray(tr.data)
        enc = encoding
        if enc is None:
            enc = 11 if np.issubdtype(data.dtype, np.integer) else 5
        if enc in (1, 3, 10, 11) and not np.issubdtype(data.dtype, np.integer):
            if not np.allclose(data, np.round(data)):
                raise MSEEDError(
                    "Cannot write non-integer data with an integer encoding."
                )
            data = np.round(data)
        if enc in (1, 3, 10, 11) and len(data):
            limit = 32767 if enc == 1 else 2147483647
            lo, hi = data.min(), data.max()
            if lo < -limit - 1 or hi > limit:
                raise MSEEDError(
                    f"Data range [{lo}, {hi}] overflows encoding "
                    f"{enc}; a silent wraparound would corrupt "
                    "amplitudes."
                )
        if enc in (10, 11):
            data = data.astype(np.int32)
        elif enc in _ENCODING_DTYPES:
            code, _ = _ENCODING_DTYPES[enc]
            data = data.astype(">" + code)

        sr = tr.stats.sampling_rate
        if sr <= 0:
            raise MSEEDError(
                f"Cannot encode sampling rate {sr} in SEED header."
            )
        if enc in (10, 11) and len(data):
            # All records' frames in ONE native call: the per-record
            # Python/ctypes loop previously dominated day-file writes.
            payloads, consumed_arr, rec_encs = steim_encode_records(
                data, nframes, enc
            )
            pos = 0
            for r in range(len(payloads)):
                rec_start = tr.stats.starttime + pos / sr
                header = _build_header(
                    tr.stats, rec_start, int(consumed_arr[r]),
                    int(rec_encs[r]), reclen_power, seqnum,
                )
                out += header + payloads[r].tobytes()
                seqnum += 1
                pos += int(consumed_arr[r])
            continue

        pos = 0
        while pos < len(data):
            rec_start = tr.stats.starttime + pos / sr
            _, size = _ENCODING_DTYPES[enc]
            max_samps = (reclen - 64) // size
            consumed = min(max_samps, len(data) - pos)
            payload = data[pos : pos + consumed].tobytes()
            payload = payload.ljust(reclen - 64, b"\x00")
            header = _build_header(
                tr.stats, rec_start, consumed, enc, reclen_power, seqnum
            )
            out += header + payload
            seqnum += 1
            pos += consumed

    with open(path, "wb") as f:
        f.write(bytes(out))
