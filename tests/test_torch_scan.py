# -*- coding: utf-8 -*-
"""
The detect slice of quakemigrate_torch against the JAX QuakeScan on the
tests/test_e2e_synthetic.py workload (10 stations, P and S, 100 Hz, a
planted source, 5 windows of 5 s):

- the traveltime table carried across equals QuakeScan's device table;
- DetectScan on the CPU, fed the channel blocks QuakeScan prepares,
  matches QuakeScan's fused detect window by window (float32, rtol 1e-5,
  argmax agreement >= 0.99 and tie-consistent);
- every module of the port imports with jax, pandas, matplotlib and
  quakemigrate_tpu refused.

"""

import pathlib
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from quakemigrate_tpu import QuakeScan, compute_traveltimes
from quakemigrate_tpu import util as j_util
from quakemigrate_tpu.coords import Proj
from quakemigrate_tpu.io import Archive
from quakemigrate_tpu.ops.scan_window import (
    unpack_detect_window as j_unpack_detect_window,
)
from quakemigrate_tpu.seis import UTCDateTime
from quakemigrate_tpu.signal.onsets import STALTAOnset
from quakemigrate_tpu.synthetics import (
    GaussianDerivativeWavelet,
    simulate_waveforms,
)
from quakemigrate_torch import DetectScan, traveltime_table, unravel
from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.ops.migrate import _prepare_onsets
from quakemigrate_torch.ops.scan_window import stalta_front_end

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCE = [0.0, 0.0, 15.0]
VP, VS = 5.0, 3.0
SPS = 100
TIMESTEP = 5.0
N_WINDOWS = 5
START = UTCDateTime("2021-02-18T12:00:20.0")


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """LUT, archive and a JAX QuakeScan, as in test_e2e_synthetic."""

    root = tmp_path_factory.mktemp("torch_synthetic")
    gproj = Proj(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0,
                 ellps="WGS84")
    cproj = Proj(proj="longlat", ellps="WGS84")
    grid_spec = dict(
        ll_corner=[-0.06, -0.06, 0.0], ur_corner=[0.06, 0.06, 20.0],
        node_spacing=[1.0, 1.0, 1.0], grid_proj=gproj, coord_proj=cproj,
    )
    angles = np.linspace(0, 2 * np.pi, 10, endpoint=False)
    stations = pd.DataFrame({
        "Name": [f"ST{i:02d}" for i in range(10)],
        "Longitude": 0.045 * np.cos(angles),
        "Latitude": 0.045 * np.sin(angles),
        "Elevation": np.zeros(10),
    })
    lut = compute_traveltimes(
        grid_spec, stations, method="homogeneous", phases=["P", "S"],
        vp=VP, vs=VS,
    )
    wavelet = GaussianDerivativeWavelet(4.0, SPS, 30.0)
    stream = simulate_waveforms(
        wavelet, SOURCE, lut, magnitude=2.0, angle_of_incidence=80,
        rng=np.random.default_rng(4),
    )
    day_dir = root / "mSEED" / "2021" / "049"
    day_dir.mkdir(parents=True)
    for tr in stream:
        tr.write(str(day_dir / f"{tr.stats.station}_{tr.stats.channel[-1]}.m"),
                 format="MSEED")
    archive = Archive(archive_path=root / "mSEED", stations=stations,
                      archive_format="YEAR/JD/STATION")

    onset = STALTAOnset(position="classic", sampling_rate=SPS)
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
    onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
    scan = QuakeScan(archive, lut, onset=onset, run_path=str(root / "runs"),
                     run_name="torch_parity", timestep=TIMESTEP,
                     compilation_cache=False)
    return scan, lut, archive


@pytest.fixture(scope="module")
def windows(synthetic):
    """The fused channel blocks of QuakeScan's 5 detect windows, and its
    unpacked (max_coa, max_coa_n, max_idx) for each."""

    scan, lut, archive = synthetic
    scan.pre_pad, scan.post_pad = scan.onset.pad(TIMESTEP)
    blocks, reference = [], []
    for i in range(N_WINDOWS):
        w_beg = START + TIMESTEP * i - scan.pre_pad
        w_end = START + TIMESTEP * (i + 1) - 1 / SPS + scan.post_pad
        prepared = scan._prepare_window(archive.read_waveform_data(w_beg,
                                                                   w_end))
        assert prepared["fused_kind"] == "stalta"
        blocks.append(tuple(np.asarray(a) for a in prepared["fused"]))
        packed = scan._run_detect_batch({i: prepared})[i]
        reference.append(j_unpack_detect_window(packed))
    fsmp = j_util.time2sample(scan.pre_pad, SPS)
    lsmp = j_util.time2sample(scan.post_pad, SPS)
    return blocks, reference, fsmp, lsmp


def _port_scan(synthetic, fsmp, lsmp):
    scan, lut, _ = synthetic
    slots = scan._canonical_slots()
    tt = traveltime_table([lut[st][ph] for ph, st in slots], scan.scan_rate)
    onset = scan.onset
    return DetectScan(
        tt, tuple(lut.node_count), fsmp, lsmp,
        front_end=stalta_front_end(onset.position, onset.signal_transform,
                                   onset.min_onset_value),
        device="cpu",
    )


def test_traveltime_table_equals_quakescan_device_table(synthetic):
    scan, lut, _ = synthetic
    scan._build_device_state()
    tables = [lut[st][ph] for ph, st in scan._canonical_slots()]
    tt = traveltime_table(tables, scan.scan_rate)
    ref = np.asarray(scan._device_tt)
    assert tt.dtype == np.int32 and tt.shape == ref.shape
    np.testing.assert_array_equal(tt, ref)


def test_detect_scan_matches_quakescan(synthetic, windows):
    blocks, reference, fsmp, lsmp = windows
    port = _port_scan(synthetic, fsmp, lsmp)
    results = port.detect(blocks)
    assert len(results) == N_WINDOWS
    peaks = []
    for block, got, ref in zip(blocks, results, reference):
        max_coa, max_coa_n, max_idx, ijk = got
        assert max_coa.dtype == np.float32 and max_idx.dtype == np.int32
        np.testing.assert_allclose(max_coa, ref[0], rtol=1e-5)
        np.testing.assert_allclose(max_coa_n, ref[1], rtol=1e-5)
        assert (max_idx == ref[2]).mean() >= 0.99
        np.testing.assert_array_equal(ijk, unravel(max_idx, port.node_count))

        # tie-consistency: the coalescence at the port's node is the max
        tensors = [torch.from_numpy(a) for a in block]
        combined, available = port.front_end(*tensors)
        logged = _prepare_onsets(combined, tensors[2]).numpy()
        t = np.arange(len(max_idx))
        cols = fsmp + port.traveltimes[max_idx].T + t
        at_port = np.exp(np.take_along_axis(
            logged.astype(np.float64), cols, axis=1).sum(0)
            / float(available))
        np.testing.assert_allclose(at_port, ref[0], rtol=1e-5)
        peaks.append(max_coa.max())
    assert np.argmax(peaks) == 2  # the planted source, 12:00:30


def test_detect_scan_rejects_window_without_live_slot(synthetic, windows):
    blocks, reference, fsmp, lsmp = windows
    port = _port_scan(synthetic, fsmp, lsmp)
    channels, chan_mask, slot_mask, nsta, nlta = blocks[0]
    dead = (np.zeros_like(channels), np.zeros_like(chan_mask),
            np.zeros_like(slot_mask), nsta, nlta)
    results = port.detect([dead, blocks[1]])
    assert results[0] is None
    np.testing.assert_allclose(results[1][0], reference[1][0], rtol=1e-5)


def test_unravel_matches_lut_grid_indices(synthetic, windows):
    _, lut, _ = synthetic
    idx = windows[1][2][2]
    grid = lut.index2grid(idx, unravel=True)
    expected = lut.ll_corner + unravel(idx, lut.node_count) * lut.node_spacing
    np.testing.assert_allclose(grid, expected)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").index is not None
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_detect_scan_defaults_to_cuda():
    """Without a device DetectScan targets the card: here, where CUDA is
    absent, it raises rather than run on the CPU."""

    tt = np.zeros((2 * 2 * 2, 4), np.int32)
    if torch.cuda.is_available():
        scan = DetectScan(tt, (2, 2, 2), 10, 10)
        assert scan.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DetectScan(tt, (2, 2, 2), 10, 10)
    assert DetectScan(tt, (2, 2, 2), 10, 10, device="cpu").device == (
        torch.device("cpu"))


_ISOLATION = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "pandas", "matplotlib", "quakemigrate_tpu")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"refused import of {name}")
        return None

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import quakemigrate_torch
names = ["quakemigrate_torch"] + [
    m.name for m in pkgutil.walk_packages(
        quakemigrate_torch.__path__, "quakemigrate_torch.")
]
for name in names:
    importlib.import_module(name)
from quakemigrate_torch.experiments import exp_kernel_breakdown, workload
from quakemigrate_torch.ops.cuda_migrate import (
    CudaDetectVPU, migrate_detect_vpu_cuda, migrate_detect_vpu_v2_cuda,
    v2_refusal, vpu_v2_reference, vpu_v2_tables)
from quakemigrate_torch.signal.scan import detect_route
from quakemigrate_torch.experiments import exp_vpu_v2
from quakemigrate_torch.ops.cuda_breakdown import (
    detect_reduce_ablate_reference, migrate_detect_ablate_cuda,
    migrate_detect_pipelined_cuda, migrate_detect_resident_cuda,
    resident_groups, span_offsets)
from quakemigrate_torch.experiments import exp_dma_probe, exp_x16
from quakemigrate_torch.ops.cuda_x16 import migrate_detect_x16_cuda
from quakemigrate_torch.ops.cuda_probe import (
    migrate_detect_probe_cuda, stream_probe_cuda)
from quakemigrate_torch.ops.x16 import detect_reduce_stride_reference
from quakemigrate_torch import QuakeScan, Trigger, synthetics
from quakemigrate_torch.coords import Proj, Transformer, gps2dist_azimuth
from quakemigrate_torch.io import (
    Archive, Event, Run, ScanmSEED, WaveformData, read_lut, read_scanmseed,
    read_stations, read_triggered_events, write_availability,
    write_coalescence, write_cut_waveforms, write_triggered_events)
from quakemigrate_torch.io.table import Table
from quakemigrate_torch.ops.cuda_migrate import (
    migrate_map_cuda, migrate_map_v2_cuda, migrate_marginalise_cuda)
from quakemigrate_torch.ops.migrate import (
    find_max_coa, migrate_map, migrate_marginalise)
from quakemigrate_torch.io import (
    read_coalescence, read_response_inv, write_amplitudes)
from quakemigrate_torch.seis.response import (
    Inventory, read_inventory, remove_trace_response, simulate_seismometer)
from quakemigrate_torch.signal.local_mag import Amplitude, LocalMag, Magnitude
from quakemigrate_torch.util import (
    PeakToTroughError, ResponseNotFoundError, ResponseRemovalError,
    wa_response)
from quakemigrate_torch.signal import Trigger as SignalTrigger
from quakemigrate_torch.signal.pickers import GaussianPicker, PhasePicker
from quakemigrate_torch.signal.trigger import chunks2trace
from quakemigrate_torch.lut import (
    LUT, Grid3D, StationTable, compute_traveltimes, lut_from_reference,
    traveltime_table, unravel)
from quakemigrate_torch.seis import Stream, Trace, UTCDateTime, read
from quakemigrate_torch.seis.mseed import read_mseed, write_mseed
from quakemigrate_torch.seis.steim import steim_decode, steim_encode_records
from quakemigrate_torch.signal.onsets import STALTAOnset, pre_process
from quakemigrate_torch.util import (
    AttribDict, DataGapException, merge_stream, resample, shift_to_sample)
from quakemigrate_torch import (
    LUT as PortLUT, Archive as PortArchive, CudaDetectGlobal,
    compute_traveltimes as port_compute_traveltimes,
    read_lut as port_read_lut, read_stations as port_read_stations)
from quakemigrate_torch.io import read_availability, read_vmodel
from quakemigrate_torch.io.core import stations
from quakemigrate_torch.ops.cuda_migrate import (
    combine_flat_tiles, migrate_detect_global_cuda)
from quakemigrate_torch.ops.kurtosis import (
    kurtosis_cf_rows, kurtosis_onset, rolling_kurtosis)
from quakemigrate_torch.ops.scan_window import (
    detect_window_cuda, detect_window_fused_kurtosis,
    fused_kurtosis_onsets, kurtosis_front_end, stalta_front_end)
from quakemigrate_torch.signal.onsets import (
    CentredSTALTAOnset, ClassicSTALTAOnset, KurtosisOnset)
from quakemigrate_torch.core import (
    centred_sta_lta, fast_marching, find_max_coa as compat_find_max_coa,
    migrate, overlapping_sta_lta, recursive_sta_lta)
from quakemigrate_torch.core.compat import migrate as compat_migrate
from quakemigrate_torch.lut import read_nlloc
from quakemigrate_torch.ops import recursive_sta_lta as ops_recursive
from quakemigrate_torch.ops.cuda_stalta import recursive_sta_lta_cuda
from quakemigrate_torch.ops.stalta import recursive_sta_lta_plain
from quakemigrate_torch.seis.gse2 import read_gse2, write_gse2
from quakemigrate_torch.seis.resp import read_resp
from quakemigrate_torch.seis.sac import read_sac, write_sac
from quakemigrate_torch.seis.sacpz import read_sac_pz
from quakemigrate_torch.seis.segy import read_segy, write_segy
for module in ("core", "core.compat", "ops.cuda_stalta", "seis.gse2",
               "seis.resp", "seis.sac", "seis.sacpz", "seis.segy"):
    assert f"quakemigrate_torch.{module}" in names, module
for module in ("ops.kurtosis", "signal.onsets.kurtosis"):
    assert f"quakemigrate_torch.{module}" in names, module
assert "quakemigrate_torch.experiments.exp_kernel_breakdown" in names
assert "quakemigrate_torch.experiments.exp_vpu_v2" in names
for module in ("seis.response", "io.amplitudes", "signal.local_mag",
               "signal.local_mag.amplitude", "signal.local_mag.magnitude",
               "signal.local_mag.local_mag"):
    assert f"quakemigrate_torch.{module}" in names, module
from quakemigrate_torch.experiments import exp_double
from quakemigrate_torch.ops.scan_window import onset_front_end
from quakemigrate_torch.signal.onsets import Onset, OnsetData
assert "quakemigrate_torch.experiments.exp_double" in names
from quakemigrate_torch import plot
from quakemigrate_torch.plot import (
    amplitudes_summary, event_summary, pick_summary, trigger_summary)
from quakemigrate_torch.plot.amplitudes import (
    label_stations, plot_amplitudes_vs_distance)
from quakemigrate_torch.plot.lut import lut_plot
from quakemigrate_torch.plot.video import event_video
from quakemigrate_torch.plot.xy import plot_xy_files
for module in ("plot", "plot.amplitudes", "plot.event", "plot.lut",
               "plot.phase_picks", "plot.trigger", "plot.video", "plot.xy"):
    assert f"quakemigrate_torch.{module}" in names, module
assert not plot.available()
assert not [m for m in sys.modules if blocked(m)]
print(len(names))
"""


def test_port_imports_without_jax_pandas_or_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATION], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 76  # every module of the slices
