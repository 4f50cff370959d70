# -*- coding: utf-8 -*-
"""
The port's ``export`` against the JAX package's on one run directory:
the port's CPU detect -> trigger -> locate (with cut waveforms) over the
synthetic workspace of tests/torch_synthetic.py, copied and then given
what the run lacks, each with the port's own writers: a P pick that
failed (-1) at one station and a failed S pick at another, local
magnitude columns in one .event and an .amps file. Both packages export
that directory: the QuakeML, NLLoc OBS, Snuffler marker and station
files and the MFAST SAC files must be byte-equal, and ``read_run``'s
records field-equal (the port's tables against the JAX DataFrames).

"""

import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_synthetic as ws
from quakemigrate_tpu import export as j_export
from quakemigrate_torch import export
from quakemigrate_torch.lut import StationTable

torch.set_num_threads(1)

RECORD_FIELDS = ("longitude", "latitude", "depth_km", "gau_longitude",
                 "gau_latitude", "gau_depth_km", "err_x_km", "err_y_km",
                 "err_z_km", "cov_err_xyz_km", "coa", "coa_norm", "trig_coa",
                 "dec_coa", "ml", "ml_err", "ml_r2")


def _fail_picks(picks_file):
    """A P pick at the first station and an S pick at the second as the
    picker writes a failed pick: PickTime -1, PickError, SNR and Residual
    -1."""

    from quakemigrate_torch.io.table import read_csv

    header, rows = read_csv(picks_file)
    col = {name: i for i, name in enumerate(header)}
    stations = sorted({row[col["Station"]] for row in rows})
    for row in rows:
        if (row[col["Station"]], row[col["Phase"]]) in (
                (stations[0], "P"), (stations[1], "S")):
            row[col["PickTime"]] = "-1"
            for name in ("PickError", "SNR", "Residual"):
                row[col[name]] = "-1.0"
    text = "\n".join(",".join(r) for r in [header] + rows) + "\n"
    picks_file.write_text(text)
    return stations[:2]


def _amplitudes(stations):
    """An amplitude table as the port's LocalMag writes one: ids, floats,
    missing values, times, booleans and the magnitude columns."""

    from quakemigrate_torch.io.table import Table
    from quakemigrate_torch.signal.local_mag.amplitude import AMPS_COLS

    rng = np.random.default_rng(21)
    rows = []
    for i, station in enumerate(stations):
        for comp in "ENZ":
            picked = bool(i % 2)
            rows.append({
                "id": f"SC.{station}..HH{comp}",
                "epi_dist": rng.uniform(1, 30), "z_dist": rng.uniform(1, 20),
                "P_amp": rng.uniform(1e-4, 1e-2), "P_freq": rng.uniform(2, 9),
                "P_time": "2021-02-18T12:00:32.120000Z" if picked else None,
                "P_avg_amp": rng.uniform(1e-5, 1e-3),
                "P_filter_gain": rng.uniform(0.5, 1.0),
                "S_amp": rng.uniform(1e-4, 1e-2) if comp != "Z" else np.nan,
                "S_freq": rng.uniform(2, 9),
                "S_time": "2021-02-18T12:00:34.500000Z",
                "S_avg_amp": rng.uniform(1e-5, 1e-3),
                "S_filter_gain": rng.uniform(0.5, 1.0),
                "Noise_amp": rng.uniform(1e-6, 1e-5), "is_picked": picked,
                "ML": rng.uniform(0.5, 2.5) if comp != "Z" else None,
                "ML_Err": rng.uniform(0.01, 0.3) if comp != "Z" else None,
            })
    return Table.from_rows(rows, AMPS_COLS + ["ML", "ML_Err"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from quakemigrate_torch.io import write_amplitudes
    from quakemigrate_torch.signal import Trigger

    workspace = ws.build_workspace(tmp_path_factory.mktemp("torch_export"))
    scan = ws.port_scan(workspace, "port", write_cut_waveforms=True)
    scan.detect(ws.START, ws.END)
    Trigger(scan.lut, run_path=str(workspace["root"] / "runs"),
            run_name="port", plot_trigger_summary=False,
            **ws.TRIGGER).trigger(ws.START, ws.END)
    seen = []
    scan.on_event = lambda event, pass1, handle: seen.append(event)
    scan.locate(ws.START, ws.END)
    assert seen, "the synthetic run located no event"

    run_dir = workspace["root"] / "runs" / "export"
    shutil.copytree(workspace["root"] / "runs" / "port", run_dir)
    event = seen[0]
    failed = _fail_picks(run_dir / "locate" / "picks" / f"{event.uid}.picks")
    # Local magnitude columns in the .event, and an .amps file
    event.add_local_magnitude(1.234, 0.0567, 0.891)
    out = SimpleNamespace(path=run_dir, subname="")
    event.write(out, scan.lut)
    write_amplitudes(out, _amplitudes(workspace["stations"]["Name"][:4]),
                     event)
    return {"dir": run_dir, "workspace": workspace, "uid": event.uid,
            "failed": failed, "n_events": len(seen)}


def _n_failed(record):
    return sum(str(t) == "-1" for t in record.picks["PickTime"])


def _records(run):
    want = j_export.read_run(run["dir"], "km")
    got = export.read_run(run["dir"], "km")
    assert len(got) == len(want) == run["n_events"]
    return got, want


def _same_values(got, want):
    want = np.asarray(want, dtype=object if got.dtype == object
                      else None)
    assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got, want)
        return
    for a, b in zip(got, want):
        assert (a == b and type(a) is type(b)) or (a != a and b != b), (a, b)


def test_read_run_records_field_equal(run):
    got, want = _records(run)
    for g, w in zip(got, want):
        assert g.uid == w.uid and str(g.otime) == str(w.otime)
        for name in RECORD_FIELDS:
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None and b is None) or a == b or (
                a != a and b != b), (name, a, b)
        assert g.extra == w.extra
        assert g.picks.names == list(w.picks.columns)
        for name in g.picks.names:
            _same_values(g.picks[name], w.picks[name].to_numpy())
        if w.amps is None:
            assert g.amps is None
            continue
        assert g.amps.names == [w.amps.index.name] + list(w.amps.columns)
        _same_values(g.amps["id"], w.amps.index.to_numpy())
        for name in g.amps.names[1:]:
            _same_values(g.amps[name], w.amps[name].to_numpy())
    ml = [g for g in got if g.uid == run["uid"]][0]
    assert _n_failed(ml) >= 2  # the two made to fail, and any the run had
    assert round(ml.ml, 2) == 1.23 and ml.amps is not None
    with pytest.raises(AttributeError):
        export.read_run(run["dir"], units="KM")
    assert export.read_run(run["dir"] / "nowhere", "km") == []


def test_quakeml_byte_equal(run, tmp_path):
    got = export.write_quakeml(run["dir"], tmp_path / "port.xml", "km")
    j_export.write_quakeml(run["dir"], tmp_path / "jax.xml", "km")
    text = (tmp_path / "port.xml").read_bytes()
    assert text == (tmp_path / "jax.xml").read_bytes()
    assert len(got) == run["n_events"] and b"<type>ML</type>" in text
    # read_quakemigrate: an ObsPy Catalog where ObsPy imports, else the
    # records
    try:
        import obspy  # noqa: F401
    except ImportError:
        records = export.read_quakemigrate(run["dir"], "km")
        assert [r.uid for r in records] == [r.uid for r in got]


@pytest.mark.parametrize("autopick", [True, False])
def test_nlloc_obs_byte_equal(run, tmp_path, autopick):
    got, want = _records(run)
    for g, w in zip(got, want):
        export.nlloc_obs(g, tmp_path / f"{g.uid}.port.obs", autopick)
        j_export.nlloc_obs(w, tmp_path / f"{w.uid}.jax.obs", autopick)
        text = (tmp_path / f"{g.uid}.port.obs").read_text()
        assert text == (tmp_path / f"{w.uid}.jax.obs").read_text()
        picked = g.picks["PickTime" if autopick else "ModelledTime"]
        assert len(text.splitlines()) == sum(str(t) != "-1" for t in picked)


def test_nlloc_obs_without_picks_warns(tmp_path):
    record = export.EventRecord(uid="nopicks", otime=None, longitude=0.0,
                                latitude=0.0, depth_km=1.0)
    with pytest.warns(UserWarning, match="No pick information"):
        export.nlloc_obs(record, tmp_path / "empty.obs")
    assert (tmp_path / "empty.obs").read_text() == ""


def test_snuffler_byte_equal(run, tmp_path):
    got, want = _records(run)
    for g, w in zip(got, want):
        export.snuffler_markers(g, tmp_path / "port")
        j_export.snuffler_markers(w, tmp_path / "jax")
        name = f"{g.uid}/{g.uid}.markers"
        text = (tmp_path / "port" / name).read_text()
        assert text == (tmp_path / "jax" / name).read_text()
        assert text.count("phase:") == sum(
            str(t) != "-1" for t in g.picks["PickTime"])
    frame = run["workspace"]["stations"]
    for code in (None, "SC"):
        export.snuffler_stations(StationTable.of(frame), tmp_path,
                                 "port.pf", network_code=code)
        j_export.snuffler_stations(frame, tmp_path, "jax.pf",
                                   network_code=code)
        assert ((tmp_path / "port.pf").read_bytes()
                == (tmp_path / "jax.pf").read_bytes())


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_mfast_sac_byte_equal(run, tmp_path):
    from quakemigrate_torch.seis import read

    got, want = _records(run)
    frame = run["workspace"]["stations"]
    wave_dir = run["dir"] / "locate" / "raw_cut_waveforms"
    for g, w in zip(got, want):
        wave = next(wave_dir.glob(f"{g.uid}.*"))
        export.sac_mfast(g, StationTable.of(frame), tmp_path / "port", "km",
                         str(wave))
        j_export.sac_mfast(w, frame, tmp_path / "jax", "km", str(wave))
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port and port == jax
    # No file for the station whose S pick failed; the SAC files read
    # back with the port's reader, the S pick in t0
    failed_s = run["failed"][1]
    assert not [k for k in port if f".{failed_s}." in k
                and k.startswith(run["uid"])]
    one = read(str(next((tmp_path / "port").rglob("*.z"))), format="SAC")
    assert len(one) == 1 and one[0].stats.npts > 0
