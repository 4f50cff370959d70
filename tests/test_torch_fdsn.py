# -*- coding: utf-8 -*-
"""
The port's FDSN client (``quakemigrate_torch.io.fdsn``) against the JAX
package's, the cases of tests/test_fdsn.py, both served by one mocked
``urlopen`` (no test opens a connection): channel priorities, the
day-file archive layout, the StationXML sidecars, no-data and error
handling. The archive trees the two packages write must be equal byte
for byte.

"""

import io
import tempfile
import urllib.error
import urllib.parse

import numpy as np
import pandas as pd
import pytest

from quakemigrate_tpu.io import fdsn as j_fdsn
from quakemigrate_tpu.seis import Stream as JStream
from quakemigrate_tpu.seis import Trace as JTrace
from quakemigrate_tpu.seis import UTCDateTime as JUTCDateTime
from quakemigrate_torch.io import fdsn
from quakemigrate_torch.lut import StationTable
from quakemigrate_torch.seis import Stream, Trace, UTCDateTime, read
from quakemigrate_torch.util import ArchiveFDSNException

T0 = UTCDateTime("2014-06-29T18:42:00.0")


def _mseed_bytes(station, channel, starttime, npts=500, sps=50.0):
    tr = Trace(
        data=(np.random.default_rng(1).normal(size=npts) * 100).astype(
            np.int32),
        header=dict(station=station, channel=channel, network="ZK",
                    sampling_rate=sps, starttime=starttime),
    )
    with tempfile.NamedTemporaryFile(suffix=".m") as f:
        Stream([tr]).write(f.name, format="MSEED")
        f.seek(0)
        return f.read()


class _FakeResponse:
    def __init__(self, status, payload=b""):
        self.status = status
        self._payload = payload

    def read(self):
        return self._payload

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _serve(calls):
    """The mocked service: CH? channels have data for SKR01 only, DL?
    channels for SKR02; the station service returns a minimal
    StationXML."""

    def urlopen(url, timeout=None):
        calls.append(url)
        query = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(url).query))
        if "/fdsnws/station/1/query" in url:
            xml = (f"<?xml version='1.0'?><FDSNStationXML>"
                   f"<Station code='{query['station']}'/></FDSNStationXML>")
            return _FakeResponse(200, xml.encode())
        assert "/fdsnws/dataselect/1/query" in url
        station, channel = query["station"], query["channel"]
        start = UTCDateTime(query["starttime"])
        have = {"SKR01": "CH", "SKR02": "DL"}[station]
        if not any(ch.startswith(have) for ch in channel.split(",")):
            return _FakeResponse(204)
        return _FakeResponse(200, b"".join(
            _mseed_bytes(station, f"{have}{c}", start) for c in "ZNE"))

    return urlopen


@pytest.fixture
def service(monkeypatch):
    """One mocked urlopen for both packages (both modules call
    ``urllib.request.urlopen``, the same attribute)."""

    calls = []
    monkeypatch.setattr(fdsn.urllib.request, "urlopen", _serve(calls))
    assert j_fdsn.urllib.request.urlopen is fdsn.urllib.request.urlopen
    return calls


def _stations(names):
    """The same station list for each package: (port, JAX)."""

    frame = pd.DataFrame({"Name": names, "Latitude": 0.0, "Longitude": 0.0,
                          "Elevation": 0.0})
    return StationTable.of(frame), frame


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _both(tmp_path, names, stationxml=False, **options):
    """download_waveform_archive by each package into its own tree (the
    times given as text, which both read); the trees (waveforms and
    StationXML) must be equal byte for byte. Returns the port's written
    paths, relative to its archive."""

    written = {}
    for label, module, stations in zip(("port", "jax"), (fdsn, j_fdsn),
                                       _stations(names)):
        root = tmp_path / label
        extra = {"stationxml_path": root / "DATALESS"} if stationxml else {}
        written[label] = module.download_waveform_archive(
            root / "mSEED", stations, **options, **extra)
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port and port == jax
    return sorted(p.relative_to(tmp_path / "port" / "mSEED").as_posix()
                  for p in written["port"])


@pytest.mark.parametrize("pattern,expanded", [
    ("CH[ZNE]", "CHZ,CHN,CHE"),
    ("BH?", "BH?"),
    ("HH[ZN]*", "HHZ*,HHN*"),
    ("[BH]H[ZN]", "BHZ,BHN,HHZ,HHN"),
])
def test_expand_channel_pattern(pattern, expanded):
    assert fdsn._expand_channel_pattern(pattern) == expanded
    assert j_fdsn._expand_channel_pattern(pattern) == expanded


def test_expand_channel_pattern_refuses_ranges():
    with pytest.raises(ArchiveFDSNException, match="Cannot expand"):
        fdsn._expand_channel_pattern("HH[Z-E]")


def test_get_waveforms_and_no_data(service):
    st = fdsn.get_waveforms("ZK", "SKR01", "*", "CH[ZNE]", T0, T0 + 20)
    ref = j_fdsn.get_waveforms("ZK", "SKR01", "*", "CH[ZNE]", str(T0),
                               str(T0 + 20))
    assert {tr.stats.channel for tr in st} == {"CHZ", "CHN", "CHE"}
    assert [tr.id for tr in st] == [tr.id for tr in ref]
    for a, b in zip(st, ref):
        np.testing.assert_array_equal(a.data, b.data)
        assert str(a.stats.starttime) == str(b.stats.starttime)
    assert len(fdsn.get_waveforms("ZK", "SKR01", "*", "DL[ZNE]", T0,
                                  T0 + 20)) == 0
    assert service[0] == service[1]  # the same query from each package


def test_download_archive_layout_and_priorities(service, tmp_path):
    names = _both(tmp_path, ["SKR01", "SKR02"], network="ZK",
                  starttime=str(T0), endtime=str(T0 + 20),
                  channel_priorities=["CH[ZNE]", "DL[ZNE]"],
                  stationxml=True)
    assert names == [
        "2014/180/SKR01_E.m", "2014/180/SKR01_N.m", "2014/180/SKR01_Z.m",
        "2014/180/SKR02_E.m", "2014/180/SKR02_N.m", "2014/180/SKR02_Z.m",
    ]
    st = read(str(tmp_path / "port" / "mSEED" / "2014" / "180"
                  / "SKR02_Z.m"))
    assert st[0].stats.channel == "DLZ"
    for station in ("SKR01", "SKR02"):
        assert (tmp_path / "port" / "DATALESS" / f"ZK.{station}.xml").exists()


def test_write_archive_days_splits_at_midnight(tmp_path):
    start = UTCDateTime("2014-06-29T23:59:50.0")
    header = dict(station="SKR01", channel="CHZ", network="ZK",
                  sampling_rate=50.0, starttime=start)
    written = fdsn._write_archive_days(
        tmp_path / "port", Stream([Trace(np.arange(1000, dtype=np.int32),
                                         header)]))
    j_header = dict(header, starttime=JUTCDateTime(str(start)))
    j_fdsn._write_archive_days(
        tmp_path / "jax", JStream([JTrace(np.arange(1000, dtype=np.int32),
                                          j_header)]))
    names = sorted(p.relative_to(tmp_path / "port").as_posix()
                   for p in written)
    assert names == ["2014/180/SKR01_Z.m", "2014/181/SKR01_Z.m"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    day1 = read(str(tmp_path / "port" / "2014" / "180" / "SKR01_Z.m"))[0]
    day2 = read(str(tmp_path / "port" / "2014" / "181" / "SKR01_Z.m"))[0]
    assert day1.stats.npts == 500 and day2.stats.npts == 500
    assert day2.stats.starttime == UTCDateTime("2014-06-30T00:00:00")
    np.testing.assert_array_equal(np.concatenate([day1.data, day2.data]),
                                  np.arange(1000))


def test_download_chunks_align_to_day_boundaries(service, tmp_path):
    names = _both(tmp_path, ["SKR01"], network="ZK",
                  starttime="2014-06-29T23:59:55.0",
                  endtime="2014-06-30T00:00:30.0",
                  channel_priorities=["CH[ZNE]"])
    assert sorted({name.split("/")[1] for name in names}) == ["180", "181"]


def test_stationxml_from_winning_datacentre(service, tmp_path, monkeypatch):
    served = fdsn.urllib.request.urlopen

    def urlopen(url, timeout=None):
        if url.startswith("https://service.iris.edu"):
            return _FakeResponse(204)
        return served(url, timeout=timeout)

    monkeypatch.setattr(fdsn.urllib.request, "urlopen", urlopen)
    _both(tmp_path, ["SKR02"], network="ZK", starttime=str(T0),
          endtime=str(T0 + 20),
          channel_priorities=["DL[ZNE]"], datacentres=("IRIS", "ORFEUS"),
          stationxml=True)
    assert (tmp_path / "port" / "DATALESS" / "ZK.SKR02.xml").exists()
    station_queries = [u for u in service if "/fdsnws/station/" in u]
    assert len(station_queries) == 2 and all(
        u.startswith("https://www.orfeus-eu.org") for u in station_queries)


@pytest.mark.parametrize("code", [500, 404])
def test_http_errors_raise(monkeypatch, code):
    def urlopen(url, timeout=None):
        raise urllib.error.HTTPError(url, code, "boom", {}, io.BytesIO())

    monkeypatch.setattr(fdsn.urllib.request, "urlopen", urlopen)
    with pytest.raises(ArchiveFDSNException, match=f"HTTP {code}"):
        fdsn.get_waveforms("ZK", "SKR01", "*", "CHZ", T0, T0 + 20)


def test_transport_error_raises(monkeypatch):
    def urlopen(url, timeout=None):
        raise urllib.error.URLError("no route")

    monkeypatch.setattr(fdsn.urllib.request, "urlopen", urlopen)
    with pytest.raises(ArchiveFDSNException, match="no route"):
        fdsn.get_stationxml("ZK", "SKR01", T0, T0 + 20)


def test_http_204_means_no_data(monkeypatch):
    def urlopen(url, timeout=None):
        raise urllib.error.HTTPError(url, 204, "none", {}, io.BytesIO())

    monkeypatch.setattr(fdsn.urllib.request, "urlopen", urlopen)
    assert len(fdsn.get_waveforms("ZK", "X", "*", "CHZ", T0, T0 + 20)) == 0
    assert fdsn.get_stationxml("ZK", "X", T0, T0 + 20) is None
