# -*- coding: utf-8 -*-
"""
Minimal FDSN web-service client for fetching the waveform data and
station metadata the examples need (each example's ``get_*_data.py``),
with no external dependencies: plain ``urllib`` against the standard
fdsnws/dataselect/1 and fdsnws/station/1 endpoints, the waveforms read
by the port's miniSEED reader. The port of the JAX package's
``io/fdsn.py``. HTTP 204 means no data; a 404 or any other failure
raises :class:`~quakemigrate_torch.util.ArchiveFDSNException`.

Typical use:

    from quakemigrate_torch.io import read_stations
    from quakemigrate_torch.io.fdsn import download_waveform_archive

    stations = read_stations("./inputs/iceland_stations.txt")
    download_waveform_archive(
        "./inputs/mSEED", stations, network="ZK",
        starttime=UTCDateTime("2014-06-29T18:42:00.0"),
        endtime=UTCDateTime("2014-06-29T18:42:20.0"),
        channel_priorities=["CH[ZNE]", "DL[ZNE]"],
        stationxml_path="./inputs/DATALESS",
    )

The archive is written in the ``YEAR/JD/STATION_COMP.m`` layout the
bundled examples read (Archive ``archive_format="YEAR/JD/STATION"``).

"""

import logging
import pathlib
import re
import tempfile
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

from quakemigrate_torch import util
from quakemigrate_torch.seis import Stream, Trace, UTCDateTime, read

# Routable FDSN data centres (service root URLs; the standard
# fdsnws/<service>/1/query path is appended).
DATACENTRES = {
    "IRIS": "https://service.iris.edu",
    "ORFEUS": "https://www.orfeus-eu.org",
    "GFZ": "https://geofon.gfz-potsdam.de",
    "INGV": "https://webservices.ingv.it",
    "ETH": "https://eida.ethz.ch",
    "GEONET": "https://service.geonet.org.nz",
    "RASPISHAKE": "https://data.raspberryshake.org",
    "NCEDC": "https://service.ncedc.org",
    "SCEDC": "https://service.scedc.caltech.edu",
}

# One day — the chunk length for long archive downloads, matching the
# day-file layout detect scans.
_DAY = 86400.0


def _service_url(datacentre, service, **params):
    """Build a fdsnws query URL for ``service`` ("dataselect"/"station")."""

    base = DATACENTRES.get(str(datacentre).upper(), datacentre).rstrip("/")
    query = urllib.parse.urlencode(
        {k: v for k, v in params.items() if v is not None}
    )
    return f"{base}/fdsnws/{service}/1/query?{query}"


def _http_get(url, timeout=120):
    """GET ``url``; returns response bytes, or None on 204 (no data)."""

    try:
        with urllib.request.urlopen(url, timeout=timeout) as response:
            if response.status == 204:
                return None
            return response.read()
    except urllib.error.HTTPError as e:
        # Only 204 means "no data matching the request" unless the client
        # asked for nodata=404 (this one never does); a 404 here is a
        # wrong/misspelt endpoint and must surface, not read as no-data.
        if e.code == 204:
            return None
        raise util.ArchiveFDSNException(
            f"FDSN request failed with HTTP {e.code}: {url}"
        ) from e
    except urllib.error.URLError as e:
        raise util.ArchiveFDSNException(
            f"FDSN request failed ({e.reason}): {url}"
        ) from e


def _time_str(t):
    return UTCDateTime(t).isoformat()


# Channel-priority patterns use fnmatch-ish FDSN glob syntax; expand
# [ZNE]-style character classes (any number of them, e.g. "[BH]H[ZNE]")
# into the comma-lists FDSN accepts. dataselect does not understand
# bracket classes, so a pattern this expander cannot normalise would be
# sent verbatim and silently return no data — raise instead.
def _expand_channel_pattern(pattern):
    expanded = [pattern]
    while any("[" in p for p in expanded):
        nxt = []
        for p in expanded:
            m = re.match(r"([A-Z0-9?*]*)\[([A-Z0-9]+)\](.*)", p)
            if not m:
                raise util.ArchiveFDSNException(
                    f"Cannot expand FDSN channel pattern {pattern!r}: "
                    "bracket classes may only contain [A-Z0-9]."
                )
            head, chars, tail = m.groups()
            nxt.extend(f"{head}{c}{tail}" for c in chars)
        expanded = nxt
    return ",".join(expanded)


def get_waveforms(network, station, location, channel, starttime, endtime,
                  datacentre="IRIS", timeout=120):
    """
    Fetch waveforms over FDSN dataselect and return them as a Stream
    (empty Stream when the data centre has no matching data).

    """

    url = _service_url(
        datacentre, "dataselect", network=network, station=station,
        location=location or "--", channel=_expand_channel_pattern(channel),
        starttime=_time_str(starttime), endtime=_time_str(endtime),
    )
    logging.debug(f"FDSN dataselect: {url}")
    payload = _http_get(url, timeout=timeout)
    if payload is None:
        return Stream()
    with tempfile.NamedTemporaryFile(suffix=".mseed") as f:
        f.write(payload)
        f.flush()
        return read(f.name, format="MSEED")


def get_stationxml(network, station, starttime, endtime, datacentre="IRIS",
                   level="response", timeout=120):
    """
    Fetch a StationXML document (default level=response, suitable for
    ``response_removal``); returns the XML text or None when no metadata
    matches.

    """

    url = _service_url(
        datacentre, "station", network=network, station=station,
        starttime=_time_str(starttime), endtime=_time_str(endtime),
        level=level, format="xml",
    )
    logging.debug(f"FDSN station: {url}")
    payload = _http_get(url, timeout=timeout)
    return None if payload is None else payload.decode("utf-8", "replace")


def download_waveform_archive(
    archive_path,
    stations,
    network,
    starttime,
    endtime,
    channel_priorities=("HH[ZNE]", "BH[ZNE]", "EH[ZNE]"),
    location="*",
    datacentres=("IRIS",),
    stationxml_path=None,
    timeout=120,
):
    """
    Download waveform data for every station into a
    ``YEAR/JD/STATION_COMP.m`` archive (the layout the bundled examples
    scan), day-chunked, trying each channel-priority pattern in order per
    station and each data centre in order until one returns data — the
    behaviour of ObsPy's MassDownloader restrictions that the examples'
    download scripts describe.

    Parameters
    ----------
    archive_path : str / pathlib.Path
        Root of the archive to write.
    stations : StationTable (or anything indexable by column name)
        As returned by :func:`~quakemigrate_torch.io.read_stations` (only
        the "Name" column is used).
    network : str
        FDSN network code.
    starttime, endtime : UTCDateTime (or parseable)
        Time span to download.
    channel_priorities : sequence of str, optional
        FDSN channel patterns tried in order per station; the first that
        returns data wins (e.g. ``["CH[ZNE]", "DL[ZNE]"]``).
    location : str, optional
        FDSN location code filter (default any).
    datacentres : sequence of str, optional
        Data-centre names from ``DATACENTRES`` (or raw service URLs),
        tried in order.
    stationxml_path : str / pathlib.Path, optional
        When given, also fetch level=response StationXML per station and
        write ``<stationxml_path>/<network>.<station>.xml``.
    timeout : float, optional
        Per-request timeout (seconds).

    Returns
    -------
    written : list of pathlib.Path
        The waveform files written.

    """

    archive_path = pathlib.Path(archive_path)
    starttime, endtime = UTCDateTime(starttime), UTCDateTime(endtime)
    written = []

    for name in stations["Name"]:
        got_from = None
        for datacentre in datacentres:
            for pattern in channel_priorities:
                # Chunk requests on UTC day boundaries so each response
                # maps 1:1 onto a day file (the writer additionally
                # splits any midnight-crossing trace it is handed).
                chunk = starttime
                stream = Stream()
                while chunk < endtime:
                    day0 = UTCDateTime(year=chunk.year, julday=chunk.julday)
                    chunk_end = min(day0 + _DAY, endtime)
                    stream += get_waveforms(
                        network, name, location, pattern, chunk, chunk_end,
                        datacentre=datacentre, timeout=timeout,
                    )
                    chunk = chunk_end
                if not len(stream):
                    continue
                written.extend(_write_archive_days(archive_path, stream))
                got_from = datacentre
                break  # first matching channel priority wins
            if got_from is not None:
                break  # first data centre with data wins
        if got_from is None:
            logging.warning(
                f"\tNo data for station {name} from any of {datacentres} "
                f"(channels {list(channel_priorities)})."
            )
            continue
        if stationxml_path is not None:
            # Query the data centre that actually served the waveforms —
            # the metadata for a station held only at a later data centre
            # is not at datacentres[0].
            xml = get_stationxml(
                network, name, starttime, endtime,
                datacentre=got_from, timeout=timeout,
            )
            if xml is not None:
                out = pathlib.Path(stationxml_path)
                out.mkdir(parents=True, exist_ok=True)
                (out / f"{network}.{name}.xml").write_text(xml)

    return written


def _write_archive_days(archive_path, stream):
    """Write a stream into the YEAR/JD/STATION_COMP.m day layout, one file
    per (station, component, day), merging gappy segments."""

    written = []
    by_day = {}
    for trace in stream:
        # Split midnight-crossing traces at UTC day boundaries: a trace
        # filed solely under its first sample's day would be invisible to
        # the Archive reader's day-directory glob for every later day it
        # covers. Split on the sample grid (first sample at-or-after
        # midnight opens the next day) — time-based slicing is ambiguous
        # by half a sample when the grid is off-second.
        piece = trace
        while piece is not None and piece.stats.npts:
            day0 = UTCDateTime(
                year=piece.stats.starttime.year,
                julday=piece.stats.starttime.julday,
            )
            day_end = day0 + _DAY
            sr = piece.stats.sampling_rate
            n_head = int(
                np.ceil((day_end - piece.stats.starttime) * sr - 1e-6)
            )
            if n_head >= piece.stats.npts:
                head, piece = piece, None
            else:
                head = Trace(piece.data[:n_head].copy(), piece.stats)
                tail_stats = piece.stats.copy()
                tail_stats.starttime = piece.stats.starttime + n_head / sr
                piece = Trace(piece.data[n_head:].copy(), tail_stats)
            key = (head.stats.station, head.stats.channel, day0)
            by_day.setdefault(key, Stream()).append(head)

    for (station, channel, day0), traces in by_day.items():
        day_dir = archive_path / f"{day0.year}" / f"{day0.julday:03d}"
        day_dir.mkdir(parents=True, exist_ok=True)
        path = day_dir / f"{station}_{channel[-1]}.m"
        traces.merge(method=1, fill_value=0)
        traces.write(str(path), format="MSEED")
        written.append(path)
    return written
