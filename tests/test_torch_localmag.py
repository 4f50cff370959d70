# -*- coding: utf-8 -*-
"""
Local magnitudes of the port (seis.response, the Wood-Anderson cut
waveforms, signal.local_mag and the .amps and .event files) against the
JAX package, on one located synthetic event: the geometry of
tests/test_local_mag.py (10 stations at varied distances, a 1 km tmerc
grid, homogeneous P/S traveltimes, one planted source, 100 Hz
three-component waveforms) with a generated StationXML inventory. Both
packages run detect -> trigger -> locate once (module fixture) with
``mags=LocalMag(...)`` (the Volcanotectonic_Iceland example's amplitude
and magnitude settings: a 2-20 Hz bandpass, ENV noise, the trace and
noise filters), an ``Archive`` with the inventory and its pre-filter,
the raw, real and Wood-Anderson cut waveforms and the 4-D map.

- read_inventory, simulate_seismometer and remove_trace_response against
  JAX's on a generated StationXML, with and without digital stages,
  within 1e-10 relative;
- Magnitude's per-trace and network magnitudes under each filter
  option, on the port's observations of the located event, against
  JAX's (1e-9 relative: the same float64 numpy and scipy code);
- the .amps and .event files equal to JAX's byte for byte;
- the real and Wood-Anderson cut waveforms within 1e-6 relative;
- plot_event_video keeping the 4-D map and plot_amplitudes drawing the
  amplitude figure; what still raises: RESP and SAC_PZ input without the
  responses asked for, a ``mags`` that is not a LocalMag.

"""

import numpy as np
import pandas as pd
import pytest
import torch

from quakemigrate_tpu import QuakeScan as JQuakeScan
from quakemigrate_tpu import Trigger as JTrigger
from quakemigrate_tpu import compute_traveltimes
from quakemigrate_tpu import coords as jcoords
from quakemigrate_tpu.io import Archive as JArchive
from quakemigrate_tpu.io import read_response_inv as j_read_response_inv
from quakemigrate_tpu.seis import Trace as JTrace
from quakemigrate_tpu.seis import UTCDateTime as JUTCDateTime
from quakemigrate_tpu.seis import read as j_read
from quakemigrate_tpu.seis import response as jresponse
from quakemigrate_tpu.signal.local_mag import LocalMag as JLocalMag
from quakemigrate_tpu.signal.local_mag import Magnitude as JMagnitude
from quakemigrate_tpu.signal.onsets import STALTAOnset as JSTALTAOnset
from quakemigrate_tpu.synthetics import (
    GaussianDerivativeWavelet,
    simulate_waveforms,
)
from quakemigrate_tpu.util import wa_response as j_wa_response
from quakemigrate_torch import util
from quakemigrate_torch.io import Archive, read_response_inv
from quakemigrate_torch.lut import StationTable, lut_from_reference
from quakemigrate_torch.seis import Trace, UTCDateTime, read
from quakemigrate_torch.seis import response
from quakemigrate_torch.signal import QuakeScan, Trigger
from quakemigrate_torch.signal.local_mag import LocalMag, Magnitude
from quakemigrate_torch.signal.onsets import STALTAOnset

import torch_synthetic as ws

torch.set_num_threads(1)

SOURCE = [0.0, 0.0, 15.0]
SPS = 100
START, END = "2021-02-18T12:00:20.0", "2021-02-18T12:00:45.0"
RESPONSE_PARAMS = {"water_level": 60.0, "pre_filt": (0.05, 0.06, 30, 35)}
# The Volcanotectonic_Iceland example's settings (dike_intrusion_locate.py)
AMP_PARAMS = {"signal_window": 1.0, "noise_window": 2.0,
              "noise_measure": "ENV", "bandpass_filter": True,
              "bandpass_lowcut": 2.0, "bandpass_highcut": 20.0,
              "filter_corners": 4}
MAG_PARAMS = {"A0": "Greenfield2018_bardarbunga", "use_hyp_dist": True,
              "amp_feature": "S_amp", "trace_filter": ".*H[NE]$",
              "noise_filter": 3.0}
# The same float64 numpy and scipy code on both sides
RTOL_HOST = 1e-9
RTOL_RESPONSE = 1e-10
# Cut waveforms: the same float64 deconvolution of the same samples
RTOL_WAVEFORMS = 1e-6

_STATIONXML = """<?xml version="1.0" encoding="UTF-8"?>
<FDSNStationXML xmlns="http://www.fdsn.org/xml/station/1" schemaVersion="1.1">
  <Source>quakemigrate_torch-tests</Source>
  <Created>2021-01-01T00:00:00</Created>
  <Network code="SC">
{stations}
  </Network>
</FDSNStationXML>
"""

_CHANNEL = """      <Channel code="CH{comp}" locationCode="" startDate="2020-01-01T00:00:00">
        <Latitude>{lat}</Latitude>
        <Longitude>{lon}</Longitude>
        <Elevation>0</Elevation>
        <Depth>0</Depth>
        <SampleRate>{sps}</SampleRate>
        <Response>
          <InstrumentSensitivity>
            <Value>2.08e6</Value>
            <Frequency>5.0</Frequency>
            <InputUnits><Name>M/S</Name></InputUnits>
            <OutputUnits><Name>COUNTS</Name></OutputUnits>
          </InstrumentSensitivity>
          <Stage number="1">
            <PolesZeros>
              <InputUnits><Name>M/S</Name></InputUnits>
              <OutputUnits><Name>V</Name></OutputUnits>
              <PzTransferFunctionType>{pz_type}</PzTransferFunctionType>
              <NormalizationFactor>{a0}</NormalizationFactor>
              <NormalizationFrequency>5.0</NormalizationFrequency>
              <Zero number="0"><Real>0</Real><Imaginary>0</Imaginary></Zero>
              <Zero number="1"><Real>0</Real><Imaginary>0</Imaginary></Zero>
              <Pole number="0"><Real>{p_re}</Real><Imaginary>{p_im}</Imaginary></Pole>
              <Pole number="1"><Real>{p_re}</Real><Imaginary>-{p_im}</Imaginary></Pole>
            </PolesZeros>
          </Stage>{digital}
        </Response>
      </Channel>"""

# A symmetric FIR stage (half of its coefficients, ODD symmetry) with a
# recorded delay correction, and a Coefficients stage without one
_DIGITAL = """
          <Stage number="2">
            <FIR>
              <InputUnits><Name>COUNTS</Name></InputUnits>
              <OutputUnits><Name>COUNTS</Name></OutputUnits>
              <Symmetry>ODD</Symmetry>
              <NumeratorCoefficient i="1">0.05</NumeratorCoefficient>
              <NumeratorCoefficient i="2">0.2</NumeratorCoefficient>
              <NumeratorCoefficient i="3">0.5</NumeratorCoefficient>
            </FIR>
            <Decimation>
              <InputSampleRate>{sps}</InputSampleRate>
              <Factor>1</Factor><Offset>0</Offset><Delay>0.02</Delay>
              <Correction>0.02</Correction>
            </Decimation>
          </Stage>
          <Stage number="3">
            <Coefficients>
              <InputUnits><Name>COUNTS</Name></InputUnits>
              <OutputUnits><Name>COUNTS</Name></OutputUnits>
              <CfTransferFunctionType>DIGITAL</CfTransferFunctionType>
              <Numerator>0.6</Numerator>
              <Numerator>0.4</Numerator>
            </Coefficients>
            <Decimation>
              <InputSampleRate>{sps}</InputSampleRate>
              <Factor>1</Factor><Offset>0</Offset><Delay>0</Delay>
            </Decimation>
          </Stage>"""


def stations_frame():
    """The stations of tests/test_local_mag.py: varied distances, so the
    amplitude-vs-distance fit has leverage."""

    angles = np.linspace(0, 2 * np.pi, 10, endpoint=False)
    radii = np.linspace(0.008, 0.055, 10)
    return pd.DataFrame({
        "Name": [f"ST{i:02d}" for i in range(10)],
        "Longitude": radii * np.cos(angles),
        "Latitude": radii * np.sin(angles),
        "Elevation": np.zeros(10),
    })


def make_stationxml(stations, path, digital=False, hertz=False):
    """A StationXML inventory of the stations' Z/N/E channels: a 2-pole
    velocity sensor (in rad/s or, with ``hertz``, in Hz), and with
    ``digital`` a FIR and a Coefficients stage after it."""

    pz = dict(pz_type="LAPLACE (RADIANS/SECOND)", a0=1.0, p_re=-19.8,
              p_im=20.2)
    if hertz:
        scale = 2 * np.pi
        pz = dict(pz_type="LAPLACE (HERTZ)", a0=1.0 / scale ** 2,
                  p_re=-19.8 / scale, p_im=20.2 / scale)
    blocks = []
    for _, stn in stations.iterrows():
        channels = "\n".join(
            _CHANNEL.format(comp=c, lat=stn.Latitude, lon=stn.Longitude,
                            sps=SPS, **pz,
                            digital=_DIGITAL.format(sps=SPS) if digital
                            else "")
            for c in "ZNE")
        blocks.append(
            f'    <Station code="{stn.Name}">\n'
            f"      <Latitude>{stn.Latitude}</Latitude>\n"
            f"      <Longitude>{stn.Longitude}</Longitude>\n"
            "      <Elevation>0</Elevation>\n"
            f"{channels}\n    </Station>")
    path.write_text(_STATIONXML.format(stations="\n".join(blocks)))
    return path


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_localmag")
    stations = stations_frame()
    lut = compute_traveltimes(ws.grid_spec(jcoords), stations,
                              method="homogeneous", phases=["P", "S"],
                              vp=5.0, vs=3.0)
    wavelet = GaussianDerivativeWavelet(4.0, SPS, 30.0)
    stream = simulate_waveforms(wavelet, SOURCE, lut, magnitude=2.0,
                                angle_of_incidence=80,
                                rng=np.random.default_rng(11))
    day_dir = root / "mSEED" / "2021" / "049"
    day_dir.mkdir(parents=True)
    for tr in stream:
        tr.write(str(day_dir / f"{tr.stats.station}_{tr.stats.channel[-1]}.m"),
                 format="MSEED")
    return {"root": root, "stations": stations, "lut": lut,
            "archive": root / "mSEED",
            "xml": make_stationxml(stations, root / "response.xml"),
            "xml_digital": make_stationxml(stations, root / "digital.xml",
                                           digital=True),
            "xml_hertz": make_stationxml(stations, root / "hertz.xml",
                                         hertz=True)}


def _onset(onset):
    return ws.onset_settings(onset)


def _trigger_kwargs():
    return dict(marginal_window=1.0, min_event_interval=2.0,
                normalise_coalescence=True, static_threshold=1.8,
                threshold_method="static", pad=30.0)


LOCATE_OPTIONS = dict(write_cut_waveforms=True, write_real_waveforms=True,
                      write_wa_waveforms=True, write_coalescence=True,
                      plot_event_summary=False)


def jax_run(workspace, run_name):
    runs = workspace["root"] / "runs"
    archive = JArchive(
        archive_path=workspace["archive"], stations=workspace["stations"],
        archive_format="YEAR/JD/STATION",
        response_inv=j_read_response_inv(str(workspace["xml"])),
        response_removal_params=dict(RESPONSE_PARAMS))
    mags = JLocalMag(amp_params=dict(AMP_PARAMS),
                     mag_params=dict(MAG_PARAMS), plot_amplitudes=False)
    scan = JQuakeScan(archive, workspace["lut"],
                      onset=_onset(JSTALTAOnset(position="classic",
                                                sampling_rate=SPS)),
                      run_path=str(runs), run_name=run_name, timestep=5.0,
                      marginal_window=1.0, mags=mags,
                      compilation_cache=False, **LOCATE_OPTIONS)
    scan.detect(START, END)
    JTrigger(workspace["lut"], run_path=str(runs), run_name=run_name,
             plot_trigger_summary=False, **_trigger_kwargs()).trigger(
                 START, END)
    scan.locate(START, END)
    return runs / run_name


def port_scan(workspace, run_name, mags=True, **options):
    archive = Archive(
        workspace["archive"], StationTable.of(workspace["stations"]),
        archive_format="YEAR/JD/STATION",
        response_inv=read_response_inv(str(workspace["xml"])),
        response_removal_params=dict(RESPONSE_PARAMS))
    lut = lut_from_reference(ws.reference_state(workspace["lut"]))
    if mags is True:
        mags = LocalMag(amp_params=dict(AMP_PARAMS),
                        mag_params=dict(MAG_PARAMS), plot_amplitudes=False)
    return QuakeScan(archive, lut,
                     _onset(STALTAOnset(position="classic",
                                        sampling_rate=SPS)),
                     str(workspace["root"] / "runs"), run_name,
                     device="cpu", timestep=5.0, marginal_window=1.0,
                     mags=mags, **options)


@pytest.fixture(scope="module")
def runs(workspace):
    jax_dir = jax_run(workspace, "jax")
    scan = port_scan(workspace, "port", **LOCATE_OPTIONS)
    scan.detect(START, END)
    Trigger(scan.lut, run_path=str(workspace["root"] / "runs"),
            run_name="port", plot_trigger_summary=False,
            **_trigger_kwargs()).trigger(START, END)
    seen = []
    scan.on_event = lambda event, pass1, handle: seen.append(event)
    scan.locate(START, END)
    return {"jax": jax_dir, "port": workspace["root"] / "runs" / "port",
            "scan": scan, "events": seen}


def _only(run_dir, kind, suffix):
    files = sorted((run_dir / "locate" / kind).glob(f"*{suffix}"))
    assert len(files) == 1, files
    return files[0]


# -- seis.response ------------------------------------------------------------

@pytest.mark.parametrize("xml", ["xml", "xml_digital", "xml_hertz"])
def test_read_inventory_equals_jax(workspace, xml):
    got = response.read_inventory(str(workspace[xml]))
    want = jresponse.read_inventory(str(workspace[xml]))
    assert got.stations == want.stations
    assert sorted(got.responses) == sorted(want.responses)
    assert len(got.responses) == 30
    for seed_id, epochs in want.responses.items():
        (a,), (b,) = got.responses[seed_id], epochs
        np.testing.assert_allclose(a.poles, b.poles, rtol=RTOL_RESPONSE)
        np.testing.assert_allclose(a.zeros, b.zeros, rtol=RTOL_RESPONSE)
        for name in ("normalization_factor", "sensitivity"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       rtol=RTOL_RESPONSE)
        assert (a.input_units, str(a.start), a.end) == (
            b.input_units, str(b.start), b.end)
        assert len(a.digital_stages) == len(b.digital_stages) == (
            2 if xml == "xml_digital" else 0)
        for sa, sb in zip(a.digital_stages, b.digital_stages):
            np.testing.assert_array_equal(sa.coefficients, sb.coefficients)
            assert (sa.input_sample_rate, sa.correction) == (
                sb.input_sample_rate, sb.correction)
            freqs = np.linspace(0.0, SPS / 2, 33)
            np.testing.assert_allclose(sa.freq_resp(freqs),
                                       sb.freq_resp(freqs),
                                       rtol=RTOL_RESPONSE)


def _traces(seed=3, npts=1500):
    """The same seeded counts as a port and a JAX Trace."""

    data = np.random.default_rng(seed).normal(scale=1e3, size=npts)
    header = {"network": "SC", "station": "ST03", "channel": "CHN",
              "sampling_rate": float(SPS)}
    port = Trace(data.copy(), dict(header,
                                   starttime=UTCDateTime("2021-02-18T12:00:20")))
    jax = JTrace(data.copy(), dict(header,
                                   starttime=JUTCDateTime("2021-02-18T12:00:20")))
    return port, jax


@pytest.mark.parametrize("xml", ["xml", "xml_digital"])
@pytest.mark.parametrize("output", ["VEL", "DISP"])
def test_remove_trace_response_equals_jax(workspace, xml, output):
    port_inv = response.read_inventory(str(workspace[xml]))
    jax_inv = jresponse.read_inventory(str(workspace[xml]))
    full = xml == "xml_digital"
    port, jax = _traces()
    response.remove_trace_response(port, port_inv, output=output,
                                   pre_filt=RESPONSE_PARAMS["pre_filt"],
                                   water_level=60.0, full=full)
    jresponse.remove_trace_response(jax, jax_inv, output=output,
                                    pre_filt=RESPONSE_PARAMS["pre_filt"],
                                    water_level=60.0, full=full)
    scale = np.abs(jax.data).max()
    assert scale > 0
    np.testing.assert_allclose(port.data, jax.data, rtol=RTOL_RESPONSE,
                               atol=RTOL_RESPONSE * scale)
    # The trace method is the same function
    again, _ = _traces()
    again.remove_response(port_inv, output=output,
                          pre_filt=RESPONSE_PARAMS["pre_filt"])
    if not full:
        np.testing.assert_array_equal(again.data, port.data)


@pytest.mark.parametrize("water_level", [60.0, 20.0])
@pytest.mark.parametrize("taper", [True, False])
def test_simulate_seismometer_equals_jax(workspace, water_level, taper):
    resp = response.read_inventory(str(workspace["xml_digital"])).responses[
        "SC.ST03..CHN"][0]
    paz = response.paz_for_output(resp, "DISP")
    port, _ = _traces(seed=5, npts=1234)
    kwargs = dict(paz_remove=paz, paz_simulate=util.wa_response(),
                  water_level=water_level, pre_filt=(0.1, 0.2, 20, 30),
                  taper=taper, stages_remove=resp.digital_stages)
    got = response.simulate_seismometer(port.data, SPS, **kwargs)
    want = jresponse.simulate_seismometer(
        port.data, SPS, **dict(kwargs, paz_simulate=j_wa_response()))
    np.testing.assert_allclose(got, want, rtol=RTOL_RESPONSE,
                               atol=RTOL_RESPONSE * np.abs(want).max())
    assert util.wa_response("DIS2VEL", False) == j_wa_response("DIS2VEL",
                                                               False)


# -- locate with magnitudes ---------------------------------------------------

def test_amps_file_equals_jax(runs):
    got = _only(runs["port"], "amplitudes", ".amps").read_bytes()
    want = _only(runs["jax"], "amplitudes", ".amps").read_bytes()
    assert got == want
    amps = pd.read_csv(_only(runs["port"], "amplitudes", ".amps"),
                       index_col=0)
    assert len(amps) == 30
    assert amps["S_amp"].notna().sum() > 20 and amps["ML"].notna().sum() > 10


def test_event_file_equals_jax(runs):
    got = _only(runs["port"], "events", ".event").read_bytes()
    want = _only(runs["jax"], "events", ".event").read_bytes()
    assert got == want
    event = pd.read_csv(_only(runs["port"], "events", ".event")).iloc[0]
    assert np.isfinite(float(event["ML"]))


@pytest.mark.parametrize("kind", ["raw", "real", "wa"])
def test_cut_waveforms_equal_jax(runs, kind):
    got = read(str(_only(runs["port"], f"{kind}_cut_waveforms", ".m")))
    want = j_read(str(_only(runs["jax"], f"{kind}_cut_waveforms", ".m")))
    assert len(got) == len(want) == 30
    for a, b in zip(sorted(got, key=lambda tr: tr.id),
                    sorted(want, key=lambda tr: tr.id)):
        assert a.id == b.id
        assert str(a.stats.starttime) == str(b.stats.starttime)
        assert a.stats.npts == b.stats.npts
        if kind == "raw":
            np.testing.assert_array_equal(a.data, b.data)
        else:
            np.testing.assert_allclose(
                a.data, b.data, rtol=RTOL_WAVEFORMS,
                atol=RTOL_WAVEFORMS * np.abs(b.data).max())


def _amplitude_frames(runs):
    """The port's .amps-stage observations (Table) and the same as a
    DataFrame indexed by id, for both packages' Magnitude."""

    (event,) = runs["events"]
    scan = runs["scan"]
    table = scan.mags.amp.get_amplitudes(event, scan.lut)
    frame = pd.DataFrame({name: list(table[name]) for name in table.names[1:]},
                         index=pd.Index(list(table["id"]), name="id"))
    for name in frame.columns:
        if name not in ("P_time", "S_time", "is_picked"):
            frame[name] = frame[name].astype(float)
    return table, frame


@pytest.mark.parametrize("params", [
    {},
    {"weighted_mean": True, "r2_only_used": False},
    {"station_filter": ["ST01", "ST07"], "dist_filter": 5.0},
    {"pick_filter": True, "use_hyp_dist": False, "A0": "UK",
     "station_corrections": {"SC.ST02..CHE": 0.1}, "amp_multiplier": 2.0},
    {"noise_filter": 0.0, "trace_filter": None, "amp_feature": "P_amp"},
], ids=["example", "weighted", "station_dist", "picks_uk", "p_amp"])
def test_magnitude_equals_jax(runs, params):
    table, frame = _amplitude_frames(runs)
    mag_params = dict(MAG_PARAMS, **params)
    port, jax = Magnitude(dict(mag_params)), JMagnitude(dict(mag_params))
    got = port.calculate_magnitudes(table)
    want = jax.calculate_magnitudes(frame)
    for name in ("ML", "ML_Err"):
        np.testing.assert_allclose(np.asarray(got[name], dtype=float),
                                   want[name].to_numpy(dtype=float),
                                   rtol=RTOL_HOST, equal_nan=True)
    if params.get("noise_filter") == 0.0 and np.isnan(want["ML"]).all():
        return
    got_mean = port.mean_magnitude(got)
    want_mean = jax.mean_magnitude(want)
    np.testing.assert_allclose(got_mean[:3], want_mean[:3], rtol=RTOL_HOST,
                               equal_nan=True)
    assert list(got_mean[3]["id"]) == list(want_mean[3].index)
    np.testing.assert_array_equal(got_mean[3]["Used"],
                                  want_mean[3]["Used"].to_numpy())


def test_locate_event_attrib_has_magnitudes(runs):
    (row,) = runs["scan"].locate_event_attrib
    assert {"magnitudes", "map_write"} <= set(row)
    assert min(row.values()) >= 0


# -- what still raises --------------------------------------------------------

def test_options_that_still_raise(runs, workspace, tmp_path, monkeypatch):
    # plot_event_video, once refused, keeps the 4-D map for the event
    # video (its drawing: tests/test_torch_plot.py), and LocalMag's
    # plot_amplitudes draws the amplitude figure at the JAX package's path
    import matplotlib.pyplot as plt

    import quakemigrate_torch.plot.video as video

    drawn, saved = [], []
    monkeypatch.setattr(video, "event_video",
                        lambda run, event, lut: drawn.append(event.map4d))
    monkeypatch.setattr(plt, "savefig",
                        lambda fname, *a, **k: saved.append(str(fname)))
    mags = LocalMag(amp_params=dict(AMP_PARAMS), mag_params=dict(MAG_PARAMS))
    scan = port_scan(workspace, "video", mags=mags, plot_event_video=True,
                     plot_event_summary=False)
    (trigger_file,) = (runs["port"] / "trigger" / "events").glob("*.csv")
    scan.locate(trigger_file=str(trigger_file))
    (map4d,) = drawn
    assert map4d is not None and map4d.shape[:3] == tuple(
        scan.lut.node_count)
    (uid,) = [p.stem for p in (workspace["root"] / "runs" / "video"
                               / "locate" / "events").glob("*.event")]
    assert saved == [str(workspace["root"] / "runs" / "video" / "locate"
                         / "amplitude_plots" / f"video_{uid}_AmpVsDistance"
                         ".pdf")]
    with pytest.raises(util.MagsTypeError):
        port_scan(workspace, "refused", mags=object())
    # RESP and SAC_PZ are read now (tests/test_torch_formats.py): a
    # StationXML file read as SAC_PZ holds no pole-zero block, and a RESP
    # file of a station line holds no response of its channel
    with pytest.raises(util.ResponseNotFoundError, match="pole-zero"):
        read_response_inv(str(workspace["xml"]), sac_pz_format=True)
    resp = tmp_path / "RESP.SC.ST00..CHZ"
    resp.write_text("B050F03     Station:     ST00\n")
    with pytest.raises(util.ResponseNotFoundError):
        read_response_inv(str(resp)).get_response("SC.ST00..CHZ")
    with pytest.raises(util.ResponseNotFoundError):
        response.read_inventory(str(workspace["xml"])).get_response(
            "SC.XX..CHZ")
    archive = Archive(workspace["archive"],
                      StationTable.of(workspace["stations"]),
                      archive_format="YEAR/JD/STATION")
    data = archive.read_waveform_data(UTCDateTime(START),
                                      UTCDateTime("2021-02-18T12:00:22"))
    with pytest.raises(AttributeError, match="response inventory"):
        data.get_real_waveform(data.waveforms[0])
    assert "No instrument response" in archive.__str__(response_only=True)
