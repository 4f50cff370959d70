# -*- coding: utf-8 -*-
"""
The reference's options on the port's QuakeScan and STALTAOnset, against
the JAX classes on the same kwargs (CPU only):

- every option of the JAX QuakeScan's table is in the port's, with the
  same default, and the STA/LTA defaults are equal;
- the deprecated names ``time_step``, ``n_cores`` and ``sampling_rate``
  of QuakeScan, and ``onset_centred``, ``p_bp_filter``, ``s_bp_filter``,
  ``p_onset_win`` and ``s_onset_win`` of STALTAOnset, set the same
  attributes and print the same notices; None is ignored; instances
  share no default table;
- the deprecated classes ``CentredSTALTAOnset`` and
  ``ClassicSTALTAOnset``;
- the device options that change only speed (``kernel``,
  ``mxu_encoding``, ``detect_batch``, ``threads``, ``tile``,
  ``fused_detect``, ``compilation_cache``) are accepted and validated as
  the reference validates them; ``kernel="xla"`` takes K3 on a CUDA
  device type; ``precision="double"`` is accepted as the reference
  accepts it (float64 device work, on the "k3" route of a CUDA device
  type: tests/test_torch_double.py); a ``mesh`` that is not a
  ``parallel.Mesh`` raises, with either precision, and a mesh of the CPU
  is accepted with either (tests/test_torch_scan_mesh.py runs it).

"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quakemigrate_tpu import QuakeScan as JQuakeScan
from quakemigrate_tpu import compute_traveltimes as j_compute_traveltimes
from quakemigrate_tpu import coords as j_coords
from quakemigrate_tpu.signal.onsets import (
    CentredSTALTAOnset as JCentredSTALTAOnset,
    ClassicSTALTAOnset as JClassicSTALTAOnset,
    STALTAOnset as JSTALTAOnset,
)
from quakemigrate_torch.lut import lut_from_reference
from quakemigrate_torch.parallel import make_mesh
from quakemigrate_torch.signal.onsets import (
    CentredSTALTAOnset,
    ClassicSTALTAOnset,
    STALTAOnset,
)
from quakemigrate_torch.signal.scan import QuakeScan

import torch_synthetic as ws

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def luts():
    stations = ws.stations_frame()
    j_lut = j_compute_traveltimes(ws.grid_spec(j_coords), stations,
                                  method="homogeneous", phases=["P", "S"],
                                  vp=ws.VP, vs=ws.VS)
    return j_lut, lut_from_reference(ws.reference_state(j_lut))


def _both(luts, tmp_path, capsys, **kwargs):
    """The JAX and the port QuakeScan on ``kwargs``, each with what it
    printed."""

    j_lut, lut = luts
    kwargs.setdefault("compilation_cache", False)
    j_scan = JQuakeScan(None, j_lut, JSTALTAOnset(sampling_rate=ws.SPS),
                        str(tmp_path), "jax", **kwargs)
    j_out = capsys.readouterr().out
    scan = QuakeScan(SimpleNamespace(stations=ws.stations_frame()["Name"]),
                     lut, STALTAOnset(sampling_rate=ws.SPS), str(tmp_path),
                     "port", device="cpu", **kwargs)
    return j_scan, j_out, scan, capsys.readouterr().out


def test_option_tables_cover_the_reference():
    for option, default in JQuakeScan._OPTION_DEFAULTS.items():
        assert option in QuakeScan._OPTION_DEFAULTS, option
        assert QuakeScan._OPTION_DEFAULTS[option] == default, option
    assert STALTAOnset._DEFAULTS == JSTALTAOnset._DEFAULTS


@pytest.mark.parametrize("legacy, value, attr", [
    ("time_step", 1.0, "timestep"),
    ("n_cores", 4, "threads"),
    ("sampling_rate", 50, None),
])
def test_quakescan_legacy_names(luts, tmp_path, capsys, legacy, value,
                                attr):
    j_scan, j_out, scan, out = _both(luts, tmp_path, capsys,
                                     **{legacy: value})
    assert out == j_out and "Parameter name has changed" in out
    if attr is not None:
        assert getattr(scan, attr) == getattr(j_scan, attr) == value
        assert getattr(scan, legacy) == value
    assert scan.scan_rate == j_scan.scan_rate == ws.SPS
    assert scan.timestep == j_scan.timestep


def test_quakescan_legacy_none_is_ignored(luts, tmp_path, capsys):
    j_scan, j_out, scan, out = _both(luts, tmp_path, capsys, time_step=None,
                                     n_cores=None, sampling_rate=None)
    assert out == j_out == ""
    assert (scan.timestep, scan.threads) == (j_scan.timestep,
                                             j_scan.threads) == (120.0, 1)


@pytest.mark.parametrize("option, value", [
    ("kernel", "auto"), ("kernel", "mxu"), ("kernel", "xla"),
    ("mxu_encoding", "i8x3"), ("mxu_encoding", "bf16hl"),
    ("detect_batch", 0), ("detect_batch", "3"), ("threads", 8),
    ("tile", 512), ("fused_detect", False), ("compilation_cache", False),
    ("plot_all_stns", False),
])
def test_device_options_accepted_as_the_reference(luts, tmp_path, capsys,
                                                  option, value):
    j_scan, j_out, scan, out = _both(luts, tmp_path, capsys,
                                     **{option: value})
    assert getattr(scan, option) == getattr(j_scan, option)
    assert out == j_out


@pytest.mark.parametrize("option, value", [
    ("kernel", "pallas"), ("mxu_encoding", "fp8"),
])
def test_bad_device_options_raise_as_the_reference(luts, tmp_path, capsys,
                                                   option, value):
    j_lut, lut = luts
    with pytest.raises(ValueError, match=option):
        JQuakeScan(None, j_lut, JSTALTAOnset(sampling_rate=ws.SPS),
                   str(tmp_path), "jax", compilation_cache=False,
                   **{option: value})
    with pytest.raises(ValueError, match=option):
        QuakeScan(None, lut, STALTAOnset(sampling_rate=ws.SPS),
                  str(tmp_path), "port", device="cpu", **{option: value})


def test_precision_double_and_mesh_raise(luts, tmp_path):
    """A mesh that is not a ``parallel.Mesh`` with precision="double"
    raises for the mesh; the precision alone does not (the two tests
    below), nor with a mesh of the CPU, which takes float64 device work."""

    _, lut = luts
    with pytest.raises(TypeError, match="mesh"):
        QuakeScan(None, lut, STALTAOnset(sampling_rate=ws.SPS),
                  str(tmp_path), "port", device="cpu", precision="double",
                  mesh=object())
    scan = QuakeScan(None, lut, STALTAOnset(sampling_rate=ws.SPS),
                     str(tmp_path), "port", precision="double",
                     mesh=make_mesh([torch.device("cpu")] * 2))
    assert scan._dtype == np.float64 and scan.device.type == "cpu"


def test_mesh_raises(luts, tmp_path):
    """A mesh that is not a ``parallel.Mesh``, and a ``device`` other than
    the mesh's first, raise."""

    _, lut = luts
    with pytest.raises(TypeError, match="mesh"):
        QuakeScan(None, lut, STALTAOnset(sampling_rate=ws.SPS),
                  str(tmp_path), "port", device="cpu", mesh=object())
    with pytest.raises((ValueError, RuntimeError)):
        QuakeScan(None, lut, STALTAOnset(sampling_rate=ws.SPS),
                  str(tmp_path), "port", device="cuda",
                  mesh=make_mesh([torch.device("cpu")] * 2))


def test_precision_double_is_accepted_as_the_reference(luts, tmp_path,
                                                       capsys):
    """precision="double" is accepted by both classes and sets float64
    device work (the reference's ``_dtype``)."""

    j_lut, lut = luts
    jax_scan = JQuakeScan(None, j_lut, JSTALTAOnset(sampling_rate=ws.SPS),
                          str(tmp_path), "jax", compilation_cache=False,
                          precision="double")
    scan = QuakeScan(None, lut, STALTAOnset(sampling_rate=ws.SPS),
                     str(tmp_path), "port", device="cpu", precision="double")
    assert scan.precision == jax_scan.precision == "double"
    assert scan._dtype == jax_scan._dtype == np.float64
    assert scan._torch_dtype == torch.float64


@pytest.mark.parametrize("kernel, route", [("auto", "k1_v2"),
                                           ("mxu", "k1_v2"), ("xla", "k3")])
def test_kernel_option_selects_the_route(luts, tmp_path, capsys, kernel,
                                         route):
    """On a CUDA device type (nothing touches a card: the route is
    decided from the plan's sizes) kernel="xla" takes K3, the other
    values detect_route's kernel; on the CPU the route is plain."""

    _, _, scan, _ = _both(luts, tmp_path, capsys, kernel=kernel)
    assert scan._detect_route()[0] == "plain"
    scan.device, scan._route = torch.device("cuda"), None
    assert scan._detect_route()[0] == route


@pytest.mark.parametrize("kwargs", [
    {"onset_centred": True},
    {"onset_centred": False, "position": "centred"},
    {"p_bp_filter": [1, 10, 2]},
    {"s_bp_filter": [1.5, 12, 3]},
    {"p_onset_win": [0.5, 5.0]},
    {"s_onset_win": [0.3, 2.0]},
    {"onset_centred": True, "p_onset_win": [0.5, 5.0],
     "p_bp_filter": [1, 10, 2]},
    {"p_onset_win": None, "onset_centred": None},
])
def test_stalta_legacy_names(capsys, kwargs):
    j_onset = JSTALTAOnset(sampling_rate=ws.SPS, **kwargs)
    j_out = capsys.readouterr().out
    onset = STALTAOnset(sampling_rate=ws.SPS, **kwargs)
    assert capsys.readouterr().out == j_out
    for attr in ("position", "bandpass_filters", "sta_lta_windows",
                 "onset_centred", "p_bp_filter", "s_bp_filter",
                 "p_onset_win", "s_onset_win", "pre_pad"):
        assert getattr(onset, attr) == getattr(j_onset, attr), attr
    onset.post_pad = j_onset.post_pad = 3.5
    assert onset.post_pad == j_onset.post_pad
    assert onset.pad(10.0) == j_onset.pad(10.0)


def test_stalta_instances_share_no_default_table():
    a = STALTAOnset(sampling_rate=ws.SPS, p_onset_win=[0.5, 5.0])
    b = STALTAOnset(sampling_rate=ws.SPS)
    assert a.sta_lta_windows["P"] == [0.5, 5.0]
    assert b.sta_lta_windows["P"] == [0.2, 1.0]
    assert STALTAOnset._DEFAULTS["sta_lta_windows"]["P"] == [0.2, 1.0]


@pytest.mark.parametrize("names", [
    (CentredSTALTAOnset, JCentredSTALTAOnset),
    (ClassicSTALTAOnset, JClassicSTALTAOnset),
])
def test_deprecated_stalta_classes(capsys, names):
    port_cls, jax_cls = names
    j_onset = jax_cls(sampling_rate=ws.SPS, position="other")
    j_out = capsys.readouterr().out
    onset = port_cls(sampling_rate=ws.SPS, position="other")
    assert capsys.readouterr().out == j_out and "deprecated" in j_out
    assert isinstance(onset, STALTAOnset)
    assert onset.position == j_onset.position
    assert type(onset).__name__ == type(j_onset).__name__


def test_legacy_onset_scans_as_the_reference(luts, tmp_path, capsys):
    """An old script's onset reaches the scan: the centred position and
    the P windows set by the deprecated names are the ones the port's
    detect front end and pads use, as the reference's."""

    j_lut, lut = luts
    legacy = dict(onset_centred=True, p_onset_win=[0.5, 5.0])
    j_scan = JQuakeScan(None, j_lut,
                        JSTALTAOnset(sampling_rate=ws.SPS, **legacy),
                        str(tmp_path), "jax", compilation_cache=False)
    scan = QuakeScan(SimpleNamespace(stations=ws.stations_frame()["Name"]),
                     lut, STALTAOnset(sampling_rate=ws.SPS, **legacy),
                     str(tmp_path), "port", device="cpu")
    assert scan.onset.pad(5.0) == j_scan.onset.pad(5.0)
    factory, settings = scan._front_end_settings()
    assert settings[0] == "centred" == j_scan.onset.position
    np.testing.assert_array_equal(scan.onset.sta_lta_windows["P"],
                                  j_scan.onset.sta_lta_windows["P"])
