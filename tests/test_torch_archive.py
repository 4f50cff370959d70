# -*- coding: utf-8 -*-
"""
The port's archive and onset preparation (quakemigrate_torch.io.Archive,
WaveformData.check_availability, STALTAOnset.pre_process and
prepare_device_inputs) against the JAX package's, on the synthetic
workspace (tests/torch_synthetic.py):

- Archive.read_waveform_data streams equal to JAX's for every window of
  the synthetic span (sample for sample, start times to the nanosecond);
- the channel blocks of prepare_device_inputs (channels, masks, nsta,
  nlta) and the availability equal to JAX's for every window, the float32
  channels at 1e-6;
- with a station's files removed from the archive, the same availability
  and masks;
- the seven named archive layouts and a custom format resolve the same
  files.

"""

import shutil

import numpy as np
import pytest

from quakemigrate_tpu import QuakeScan as JQuakeScan
from quakemigrate_tpu.io import Archive as JArchive
from quakemigrate_tpu.seis import UTCDateTime as JUTCDateTime
from quakemigrate_tpu.signal.onsets import STALTAOnset as JSTALTAOnset
from quakemigrate_tpu.signal.onsets.stalta import pre_process as j_pre_process
from quakemigrate_torch.io import Archive
from quakemigrate_torch.lut import StationTable
from quakemigrate_torch.seis import UTCDateTime
from quakemigrate_torch.signal.onsets import STALTAOnset, pre_process

import torch_synthetic as ws

N_WINDOWS = 5


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return ws.build_workspace(tmp_path_factory.mktemp("torch_archive"))


def _pair(workspace, archive_path=None, **kwargs):
    """(port archive, port onset, JAX archive, JAX onset, JAX scan)."""

    path = archive_path or workspace["archive"]
    stations = workspace["stations"]
    port = Archive(path, StationTable.of(stations),
                   archive_format="YEAR/JD/STATION", **kwargs)
    ref = JArchive(archive_path=path, stations=stations,
                   archive_format="YEAR/JD/STATION", **kwargs)
    onset = ws.onset_settings(STALTAOnset(position="classic",
                                          sampling_rate=ws.SPS))
    j_onset = ws.onset_settings(JSTALTAOnset(position="classic",
                                             sampling_rate=ws.SPS))
    j_scan = JQuakeScan(ref, workspace["lut"], onset=j_onset,
                        run_path=str(workspace["root"] / "runs"),
                        run_name="archive", timestep=ws.TIMESTEP,
                        compilation_cache=False)
    onset.post_pad = workspace["lut"].max_traveltime
    return port, onset, ref, j_onset, j_scan


def _windows(onset, utcdatetime):
    pre, post = onset.pad(ws.TIMESTEP)
    start = utcdatetime(ws.START)
    return [(start + ws.TIMESTEP * i - pre,
             start + ws.TIMESTEP * (i + 1) - 1 / ws.SPS + post)
            for i in range(N_WINDOWS)]


def _assert_streams_equal(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.id == b.id
        assert a.stats.starttime.ns == b.stats.starttime.ns
        assert a.stats.sampling_rate == b.stats.sampling_rate
        np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("i", range(N_WINDOWS))
def test_read_waveform_data_matches(workspace, i):
    port, onset, ref, j_onset, _ = _pair(workspace)
    assert onset.pad(ws.TIMESTEP) == j_onset.pad(ws.TIMESTEP)
    w_beg, w_end = _windows(onset, UTCDateTime)[i]
    r_beg, r_end = _windows(j_onset, JUTCDateTime)[i]
    assert (w_beg.ns, w_end.ns) == (r_beg.ns, r_end.ns)
    got, want = port.read_waveform_data(w_beg, w_end), \
        ref.read_waveform_data(r_beg, r_end)
    _assert_streams_equal(got.waveforms, want.waveforms)
    _assert_streams_equal(got.raw_waveforms, want.raw_waveforms)
    for phase in ("P", "S"):
        a = pre_process(got.waveforms.select(channel=onset.channel_maps[
            phase]), ws.SPS, False, None, onset.bandpass_filters[phase],
            got.starttime, got.endtime)
        b = j_pre_process(want.waveforms.select(channel=j_onset.channel_maps[
            phase]), ws.SPS, False, None, j_onset.bandpass_filters[phase],
            want.starttime, want.endtime)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.stats.starttime.ns == y.stats.starttime.ns
            np.testing.assert_allclose(x.data, y.data, rtol=1e-12,
                                       atol=1e-12)


def _blocks(port, onset, ref, j_scan, i):
    w_beg, w_end = _windows(onset, UTCDateTime)[i]
    r_beg, r_end = _windows(j_scan.onset, JUTCDateTime)[i]
    slots = j_scan._canonical_slots()
    got = onset.prepare_device_inputs(port.read_waveform_data(w_beg, w_end),
                                      slots)
    want = j_scan.onset.prepare_device_inputs(
        ref.read_waveform_data(r_beg, r_end), slots, dtype=np.float32)
    return got, want


def _assert_blocks_equal(got, want):
    channels, chan_mask, slot_mask, nsta, nlta, availability = got
    assert channels.dtype == np.float32 and channels.shape == want[0].shape
    np.testing.assert_allclose(channels, want[0], rtol=1e-6, atol=1e-6)
    for a, b in zip((chan_mask, slot_mask, nsta, nlta), want[1:5]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert availability == want[5]


@pytest.mark.parametrize("i", range(N_WINDOWS))
def test_prepare_device_inputs_matches(workspace, i):
    port, onset, ref, _, j_scan = _pair(workspace)
    got, want = _blocks(port, onset, ref, j_scan, i)
    _assert_blocks_equal(got, want)
    assert got[2].sum() == 2 * ws.N_STATIONS


@pytest.fixture(scope="module")
def gappy_archive(workspace, tmp_path_factory):
    """The archive without station ST03, and without ST07's Z file."""

    path = tmp_path_factory.mktemp("gappy") / "mSEED"
    shutil.copytree(workspace["archive"], path)
    day = path / "2021" / "049"
    for f in list(day.glob("ST03_*.m")) + [day / "ST07_Z.m"]:
        f.unlink()
    return path


@pytest.mark.parametrize("i", [0, 3])
def test_missing_station_gives_same_availability(workspace, gappy_archive, i):
    port, onset, ref, _, j_scan = _pair(workspace, gappy_archive)
    got, want = _blocks(port, onset, ref, j_scan, i)
    _assert_blocks_equal(got, want)
    availability = got[5]
    assert availability["ST03_P"] == availability["ST03_S"] == 0
    assert availability["ST07_P"] == 0 and availability["ST07_S"] == 1
    assert got[2].sum() == 2 * ws.N_STATIONS - 3


LAYOUTS = {
    "SeisComp3": "2021/SC/{sta}/CHZ.D/SC.{sta}..CHZ.D.2021.049",
    "YEAR/JD/*_STATION_*": "2021/049/X_{sta}_Z",
    "YEAR/JD/STATION": "2021/049/{sta}_Z.m",
    "STATION.YEAR.JULIANDAY": "SC.{sta}.CHZ.2021.049",
    "/STATION/STATION.YearMonthDay": "{sta}/{sta}.20210218",
    "YEAR_JD/STATION*": "2021_049/{sta}Z",
    "YEAR_JD/STATION_*": "2021_049/{sta}_Z",
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS) + ["custom"])
def test_archive_layouts_find_the_same_files(tmp_path, layout):
    stations = ws.stations_frame()
    template = LAYOUTS.get(layout, "day{jday:03d}/{station}.mseed")
    for sta in stations["Name"]:
        rel = (LAYOUTS[layout].format(sta=sta) if layout in LAYOUTS
               else f"day049/{sta}.mseed")
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    kwargs = ({"archive_format": layout} if layout in LAYOUTS
              else {"format": template})
    port = Archive(tmp_path, StationTable.of(stations), **kwargs)
    ref = JArchive(archive_path=tmp_path, stations=stations, **kwargs)
    assert port.format == ref.format
    got = port._candidate_files(UTCDateTime(ws.START),
                                UTCDateTime(ws.END))
    want = ref._candidate_files(JUTCDateTime(ws.START),
                                JUTCDateTime(ws.END))
    assert sorted(got) == sorted(want)
    assert len(got) == ws.N_STATIONS
