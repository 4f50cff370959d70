# -*- coding: utf-8 -*-
"""
The port's waveform formats (``quakemigrate_torch.seis.sac``, ``gse2``,
``segy``; ``seis.read``; ``Stream.write``) and response formats
(``seis.resp``, ``seis.sacpz``; ``io.read_response_inv``) against the JAX
package's:

- SAC, GSE2 and SEG-Y files written by one package read by the other,
  with equal samples and stats (the stats each format holds);
- the port's writes byte for byte JAX's for the same Stream, but for the
  bytes named: SEG-Y's textual cards 2 (the writer's name) and 3 on (the
  trace ids, which SEG-Y's trace header has no field for);
- SAC's sampling rate: both packages read the header's float32 delta
  as it is (100 Hz as 1 / float32(0.01), 100.0000022), the rates equal;
- ``read``'s format sniffing and its refusals;
- RESP and SAC_PZ inventories (the texts of tests/test_full_response.py)
  whose responses match JAX's at 200 frequencies within 1e-12, and
  ``read_response_inv``'s routes;
- cut waveforms in every format (``io.cut_waveforms.write_waveforms``),
  read back;
- QuakeScan.detect on the CPU from the synthetic workspace's archive
  (tests/torch_synthetic.py) rewritten as int32 counts in SAC, GSE2 and
  SEG-Y: the samples read back equal the miniSEED ones; from GSE2 and
  SEG-Y the .scanmseed equals the miniSEED run's byte for byte; from SAC,
  whose float32 rate the scan cannot resample to 100 Hz, both packages
  refuse every trace (availability 0) and write .scanmseed files that
  agree.

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.io import read_response_inv as j_read_response_inv
from quakemigrate_tpu.seis import Stream as JStream
from quakemigrate_tpu.seis import Trace as JTrace
from quakemigrate_tpu.seis import UTCDateTime as JUTCDateTime
from quakemigrate_tpu.seis import read as j_read
from quakemigrate_tpu.seis.response import (
    paz_to_freq_resp as j_paz_to_freq_resp,
)
from quakemigrate_torch.io import read_response_inv
from quakemigrate_torch.io.cut_waveforms import write_waveforms
from quakemigrate_torch.seis import Stream, Trace, UTCDateTime, read
from quakemigrate_torch.seis.response import Inventory, paz_to_freq_resp
from quakemigrate_torch.seis.segy import ID_CARDS
from quakemigrate_torch.util import ResponseNotFoundError

import torch_synthetic as ws
from test_full_response import _RESP, _SACPZ, _XML

torch.set_num_threads(1)

FORMATS = ("SAC", "GSE2", "SEGY")
START = "2021-02-18T12:00:07.250000"


def _traces(n_traces=3, npts=1500, rate=100.0, seed=0):
    """(headers, int32 samples) of a few channels; integer counts, which
    every format holds exactly (GSE2 holds integers only)."""

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_traces):
        header = {"network": "XX", "station": f"ST{i:02d}", "location": "",
                  "channel": f"HH{'ZNE'[i % 3]}", "sampling_rate": rate,
                  "starttime": START}
        data = np.cumsum(rng.integers(-900, 900, npts)).astype(np.int32)
        out.append((header, data))
    return out


def _streams(**kwargs):
    spec = _traces(**kwargs)
    port = Stream([Trace(d.copy(), dict(h)) for h, d in spec])
    jax = JStream([JTrace(d.copy(), dict(h)) for h, d in spec])
    return port, jax


# The stats each format writes: SAC station/channel/network; GSE2
# station/channel; SEG-Y none in its trace header (the port writes the
# ids into textual cards)
_HELD = {"SAC": ("network", "station", "channel"),
         "GSE2": ("station", "channel"), "SEGY": ()}


def _files(path, fmt, n):
    """SAC writes one file a trace, suffixed .00, .01, ... for several."""

    if fmt == "SAC" and n > 1:
        return [path.with_name(f"{path.name}.{i:02d}") for i in range(n)]
    return [path]


def _read_all(reader, path, fmt, n):
    traces = []
    for f in _files(path, fmt, n):
        traces.extend(reader(str(f)).traces)
    return traces


def _read_rate(fmt, rate):
    """The rate a reader gives back for a file written at ``rate``: SAC
    holds delta in float32, which both packages read as it is."""

    return 1.0 / float(np.float32(1.0 / rate)) if fmt == "SAC" else rate


def _assert_same(got, want, keys, rate=None):
    """Equal samples, npts, start and ``keys``; the rate ``rate``, or
    the written trace's where None."""

    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.data, np.float64),
                                      np.asarray(w.data, np.float64))
        assert g.stats.npts == w.stats.npts
        assert str(g.stats.starttime) == str(w.stats.starttime)
        assert g.stats.sampling_rate == (w.stats.sampling_rate
                                         if rate is None else rate)
        for key in keys:
            assert getattr(g.stats, key) == getattr(w.stats, key), key


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cross_read(tmp_path, fmt, writer):
    port, jax = _streams()
    path = tmp_path / f"x.{fmt.lower()}"
    (port if writer == "port" else jax).write(str(path), format=fmt)
    by_port = _read_all(read, path, fmt, len(port))
    by_jax = _read_all(j_read, path, fmt, len(port))
    # Both read SAC's float32 delta as it is (100 Hz as 100.0000022)
    rate = _read_rate(fmt, port.traces[0].stats.sampling_rate)
    _assert_same(by_port, port.traces, _HELD[fmt], rate=rate)
    _assert_same(by_jax, port.traces, _HELD[fmt], rate=rate)
    _assert_same(by_port, by_jax, _HELD[fmt])
    if fmt == "SEGY":
        got = [(t.stats.network, t.stats.station, t.stats.channel)
               for t in by_port]
        want = [(t.stats.network, t.stats.station, t.stats.channel)
                for t in port]
        # the ids in the textual cards: the port's files only
        assert got == want if writer == "port" else got != want
        assert all(t.stats.station == "" for t in by_jax)


@pytest.mark.parametrize("fmt", ["SAC", "GSE2"])
def test_writes_byte_equal_to_jax(tmp_path, fmt):
    port, jax = _streams()
    port.write(str(tmp_path / "port"), format=fmt)
    jax.write(str(tmp_path / "jax"), format=fmt)
    for p, j in zip(_files(tmp_path / "port", fmt, 3),
                    _files(tmp_path / "jax", fmt, 3)):
        assert p.read_bytes() == j.read_bytes()


def test_segy_bytes_differ_in_the_named_cards_only(tmp_path):
    port, jax = _streams()
    port.write(str(tmp_path / "port.segy"), format="SEGY")
    jax.write(str(tmp_path / "jax.segy"), format="SEGY")
    got = np.frombuffer((tmp_path / "port.segy").read_bytes(), np.uint8)
    want = np.frombuffer((tmp_path / "jax.segy").read_bytes(), np.uint8)
    assert got.size == want.size
    cards = set(np.flatnonzero(got != want) // 80)
    # card 2 (index 1): the writer's name; cards 3-5: the three trace ids
    assert cards == {1, 2, 3, 4}
    text = got[:3200].tobytes().decode("ascii")
    assert text[80:160].rstrip() == "C 2 WRITTEN BY QUAKEMIGRATE_TORCH"
    assert text[160:240].rstrip() == "C 3 TRACE    1 XX.ST00..HHZ"
    assert text[400:480].rstrip() == "C 6"


def test_segy_ids_past_the_cards(tmp_path):
    port, _ = _streams(n_traces=ID_CARDS + 2, npts=40)
    port.write(str(tmp_path / "many.segy"), format="SEGY")
    back = read(tmp_path / "many.segy")
    assert [t.id for t in back][:ID_CARDS] == [t.id for t in port][:ID_CARDS]
    assert [t.stats.station for t in back][ID_CARDS:] == ["", ""]
    for g, w in zip(back, port):
        np.testing.assert_array_equal(g.data, w.data)


@pytest.mark.parametrize("fmt", ["MSEED", *FORMATS])
def test_read_sniffs_the_format_and_trims(tmp_path, fmt):
    port, _ = _streams(n_traces=1)
    path = tmp_path / "one"
    port.write(str(path), format=fmt)
    whole = read(path)
    assert np.array_equal(np.asarray(whole[0].data, np.int64),
                          np.asarray(port[0].data, np.int64))
    start = UTCDateTime(START) + 2.0
    part = read(path, starttime=start, endtime=start + 1.0)
    # Sample 200 of the file's grid: 2 s on, or 200 float32 deltas (SAC)
    rate = _read_rate(fmt, port[0].stats.sampling_rate)
    assert part[0].stats.starttime == UTCDateTime(START) + 200 / rate
    assert part[0].stats.npts == 101
    np.testing.assert_array_equal(np.asarray(part[0].data, np.int64),
                                  port[0].data[200:301])
    assert read(path, format=fmt)[0].stats.npts == 1500


def test_read_refusals(tmp_path):
    junk = tmp_path / "junk.txt"
    junk.write_text("not a waveform\n")
    with pytest.raises(TypeError):
        j_read(junk)
    with pytest.raises(TypeError):
        read(junk)
    port, _ = _streams(n_traces=1)
    port.write(str(tmp_path / "w.m"), format="MSEED")
    with pytest.raises(TypeError, match="Unknown waveform format"):
        read(tmp_path / "w.m", format="WAV")
    with pytest.raises(ValueError, match="Unsupported output format"):
        port.write(str(tmp_path / "w.wav"), format="WAV")


def test_gse2_refuses_non_integer_samples(tmp_path):
    tr = Trace(np.linspace(0, 1, 10), {"station": "A", "sampling_rate": 1.0})
    with pytest.raises(ValueError, match="integer counts"):
        Stream([tr]).write(str(tmp_path / "f.gse2"), format="GSE2")


# -- responses ---------------------------------------------------------------------

FREQS = np.logspace(-2, np.log10(45.0), 200)


def _curve(resp, paz_fn):
    """The channel's full response at FREQS: the PAZ times the gain, times
    every digital stage's shape."""

    curve = paz_fn(FREQS, resp.poles, resp.zeros,
                   resp.normalization_factor * resp.sensitivity)
    for stage in resp.digital_stages:
        curve = curve * stage.freq_resp(FREQS)
    return curve


def _assert_inventories_match(got, want):
    assert isinstance(got, Inventory)
    assert sorted(got.responses) == sorted(want.responses)
    assert got.stations == want.stations
    for seed_id, epochs in want.responses.items():
        assert len(got.responses[seed_id]) == len(epochs)
        for g, w in zip(got.responses[seed_id], epochs):
            assert (g.poles, g.zeros) == (w.poles, w.zeros)
            assert g.input_units == w.input_units
            assert str(g.start) == str(w.start) and str(g.end) == str(w.end)
            assert len(g.digital_stages) == len(w.digital_stages)
            a = _curve(g, paz_to_freq_resp)
            b = _curve(w, j_paz_to_freq_resp)
            assert np.max(np.abs(a - b) / np.abs(b)) <= 1e-12


def _resp_channels(channels):
    return "".join(_RESP.replace("B052F04     Channel:     HHZ",
                                 f"B052F04     Channel:     {c}")
                   for c in channels)


@pytest.mark.parametrize("layout", ["file", "concatenated", "directory"])
def test_resp_inventory_matches_jax(tmp_path, layout):
    if layout == "file":
        path = tmp_path / "RESP.XX.FIR1..HHZ"
        path.write_text(_RESP)
    elif layout == "concatenated":
        path = tmp_path / "RESP.all"
        path.write_text(_resp_channels(["HHZ", "HHN", "HHE"]))
    else:
        path = tmp_path / "resp"
        path.mkdir()
        for c in ("HHZ", "HHN"):
            (path / f"RESP.XX.FIR1..{c}").write_text(_resp_channels([c]))
    got = read_response_inv(str(path))
    _assert_inventories_match(got, j_read_response_inv(str(path)))
    assert got.get_response("XX.FIR1..HHZ").digital_stages


@pytest.mark.parametrize("layout", ["file", "directory"])
def test_sac_pz_inventory_matches_jax(tmp_path, layout):
    if layout == "file":
        path = tmp_path / "SAC_PZs_XX_PZ01_HHZ"
        path.write_text(_SACPZ)
    else:
        path = tmp_path / "pz"
        path.mkdir()
        (path / "SAC_PZs_XX_PZ01_HHZ").write_text(_SACPZ)
        (path / "SAC_PZs_XX_PZ02_HHZ").write_text(
            _SACPZ.replace("PZ01", "PZ02"))
    got = read_response_inv(str(path), sac_pz_format=True)
    _assert_inventories_match(
        got, j_read_response_inv(str(path), sac_pz_format=True))
    assert got.get_coordinates("XX.PZ01..HHZ")["latitude"] == 12.5


def test_read_response_inv_routes(tmp_path):
    (tmp_path / "RESP.XX.FIR1..HHZ").write_text(_RESP)
    (tmp_path / "SAC_PZs_XX_PZ01_HHZ").write_text(_SACPZ)
    (tmp_path / "resp.xml").write_text(_XML)
    by_resp = read_response_inv(str(tmp_path / "RESP.XX.FIR1..HHZ"))
    by_xml = read_response_inv(str(tmp_path / "resp.xml"))
    by_pz = read_response_inv(str(tmp_path / "SAC_PZs_XX_PZ01_HHZ"),
                              sac_pz_format=True)
    assert list(by_resp.responses) == ["XX.FIR1..HHZ"]
    r, x = (inv.get_response("XX.FIR1..HHZ") for inv in (by_resp, by_xml))
    assert (r.poles, r.zeros, r.sensitivity) == (x.poles, x.zeros,
                                                 x.sensitivity)
    assert sorted(by_pz.responses) == ["XX.PZ01..HHN", "XX.PZ01..HHZ"]
    # XML that does not parse; a SAC_PZ file without the flag (read as
    # RESP, in which it holds no epoch)
    (tmp_path / "bad.xml").write_text("<FDSNStationXML><Network>")
    with pytest.raises(TypeError, match="StationXML"):
        read_response_inv(str(tmp_path / "bad.xml"))
    for reader in (read_response_inv, j_read_response_inv):
        with pytest.raises(ResponseNotFoundError if reader is
                           read_response_inv else Exception):
            reader(str(tmp_path / "SAC_PZs_XX_PZ01_HHZ"))
    empty = tmp_path / "nothing"
    empty.mkdir()
    with pytest.raises(ResponseNotFoundError):
        read_response_inv(str(empty), sac_pz_format=True)


# -- cut waveforms ----------------------------------------------------------------

_SUFFIX = {"MSEED": ".m", "SAC": ".sac", "GSE2": ".gse2", "SEGY": ".segy"}


@pytest.mark.parametrize("fmt", ["MSEED", *FORMATS])
def test_cut_waveforms_in_every_format(tmp_path, fmt):
    port, _ = _streams(n_traces=3)
    write_waveforms(port, tmp_path, "20210218120007250", fmt)
    path = tmp_path / f"20210218120007250{_SUFFIX[fmt]}"
    back = _read_all(read, path, fmt, 3)
    _assert_same(back, port.traces, ("network", "station", "channel")
                 if fmt in ("MSEED", "SAC", "SEGY") else ("station",
                                                          "channel"),
                 rate=_read_rate(fmt, port[0].stats.sampling_rate))


# -- detect from each format --------------------------------------------------------

@pytest.fixture(scope="module")
def format_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_formats")
    base = ws.build_workspace(root / "base")
    runs = {}
    for fmt in ("MSEED", *FORMATS):
        workspace = ws.counts_workspace(base, root / fmt, fmt)
        scan = ws.port_scan(workspace, "detect")
        scan.detect(ws.START, ws.END)
        runs[fmt] = workspace
    return runs


@pytest.mark.parametrize("fmt", FORMATS)
def test_detect_from_format_equals_mseed(format_runs, fmt):
    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.lut import StationTable

    data = {}
    for name in ("MSEED", fmt):
        workspace = format_runs[name]
        archive = Archive(workspace["archive"],
                          StationTable.of(workspace["stations"]),
                          archive_format="YEAR/JD/STATION")
        data[name] = archive.read_waveform_data(
            UTCDateTime(ws.START), UTCDateTime(ws.END), 1.0, 1.0).waveforms
    assert len(data[fmt]) == len(data["MSEED"]) == 3 * ws.N_STATIONS
    if fmt == "SAC":
        # Starts on the file's grid at the float32 rate: the JAX
        # package's read of the same archive
        from quakemigrate_tpu.io import Archive as JArchive

        starts = [tr.stats.starttime.ns for tr in JArchive(
            archive_path=format_runs[fmt]["archive"],
            stations=format_runs[fmt]["stations"],
            archive_format="YEAR/JD/STATION").read_waveform_data(
                JUTCDateTime(ws.START), JUTCDateTime(ws.END), 1.0,
                1.0).waveforms]
    else:
        starts = [tr.stats.starttime.ns for tr in data["MSEED"]]
    for got, want, start in zip(data[fmt], data["MSEED"], starts):
        assert (got.stats.station, got.stats.channel) == (
            want.stats.station, want.stats.channel)
        assert got.stats.sampling_rate == _read_rate(
            fmt, want.stats.sampling_rate)
        assert got.stats.starttime.ns == start
        np.testing.assert_array_equal(np.asarray(got.data, np.int64),
                                      want.data)
    if fmt == "SAC":
        _hold_sac_detect_to_jax(format_runs["SAC"])
        return
    files = {name: sorted((format_runs[name]["root"] / "runs" / "detect"
                           / "detect").rglob("*.scanmseed"))
             for name in ("MSEED", fmt)}
    assert len(files[fmt]) == len(files["MSEED"]) == 1
    assert files[fmt][0].read_bytes() == files["MSEED"][0].read_bytes()


def _hold_sac_detect_to_jax(workspace):
    """The SAC archive's rate, 1 / float32(0.01), is not the onset's 100
    Hz, and the scan's resample cannot conform it: the JAX package's
    detect on the archive refuses every trace, and the port's must agree,
    every availability cell 0 and the .scanmseed files within the bounds
    of the other parity tests."""

    from quakemigrate_tpu import QuakeScan as JQuakeScan
    from quakemigrate_tpu.io import Archive as JArchive
    from quakemigrate_tpu.signal import onsets as j_onsets

    runs = workspace["root"] / "runs"
    JQuakeScan(JArchive(archive_path=workspace["archive"],
                        stations=workspace["stations"],
                        archive_format="YEAR/JD/STATION"),
               workspace["lut"], onset=ws.make_onset(j_onsets),
               run_path=str(runs), run_name="jax_detect",
               timestep=ws.TIMESTEP, marginal_window=ws.MARGINAL_WINDOW,
               plot_event_summary=False, compilation_cache=False,
               ).detect(ws.START, ws.END)
    texts = {}
    for name in ("detect", "jax_detect"):
        (path,) = (runs / name / "detect" / "availability").glob("*.csv")
        texts[name] = path.read_text()
        rows = [line.split(",") for line in texts[name].splitlines()]
        assert len(rows) == 1 + 5 and len(rows[0]) == 1 + 2 * ws.N_STATIONS
        assert all(cell == "0" for row in rows[1:] for cell in row[1:]), name
    assert texts["detect"] == texts["jax_detect"]
    ws.assert_scanmseed_close(ws.scanmseed_counts(runs / "detect"),
                              ws.scanmseed_counts(runs / "jax_detect"),
                              rtol=0.0)
