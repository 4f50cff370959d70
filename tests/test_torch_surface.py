# -*- coding: utf-8 -*-
"""
The rest of the JAX package's public surface in the port, against the
JAX package on the CPU:

- ``quakemigrate_torch.ops``' device functions of migration (routed by
  the tensors' device, ``ops/routed.py``): on CPU tensors against the
  JAX ``ops`` (float32 within 1e-5 in the max and 1e-4 normalised,
  float64 within 1e-12, argmax tie-consistent); ``migrate_detect_batch``
  against the JAX vmap and bit for bit against single windows; padded
  slabs; and the detector the CUDA route builds for a flat table (its
  plan, its cache, K3's arithmetic on it);
- ``compute_traveltimes`` takes no default ``method``;
- ``lut.update_lut`` on the old-format file tests/test_update_lut.py
  builds;
- ``core.steim_py`` against the port's C codec, frame for frame;
- the standalone ``_py`` STA/LTAs within 1e-12 of the JAX ones;
- util's helpers and exceptions, ``Stream.extend``/``clear``, the CSV
  readers' ``**kwargs``, and the re-exports.

"""

import inspect
import pickle

import numpy as np
import pytest
import torch

from quakemigrate_tpu import ops as j_ops
from quakemigrate_tpu import util as j_util
from quakemigrate_torch import ops, util
from quakemigrate_torch.ops import cuda_migrate, routed

torch.set_num_threads(1)

FSMP, NSAMPLES, LSMP = 16, 100, 40
TOL = {np.float32: (1e-5, 1e-4), np.float64: (1e-12, 1e-12)}


def _windows(seed, n_windows, n_onsets=6, dtype=np.float32):
    """Gamma onsets [B, O, T] (the last onset of each window masked),
    masks [B, O] and available counts [B]."""

    rng = np.random.default_rng(seed)
    t_len = FSMP + NSAMPLES + LSMP
    onsets = rng.gamma(2.0, 1.5, size=(n_windows, n_onsets, t_len))
    mask = np.ones((n_windows, n_onsets), dtype=dtype)
    mask[:, -1] = 0.0
    return onsets.astype(dtype), mask, mask.sum(axis=1)


def _table(seed, n_nodes, n_onsets=6, high=LSMP):
    rng = np.random.default_rng(seed)
    return rng.integers(0, high, size=(n_nodes, n_onsets)).astype(np.int32)


def _coa_at(onsets, tt, mask, available, idx):
    """Float64 coalescence of flat node idx[t] at sample t."""

    logged = np.log(np.clip(onsets.astype(np.float64), 0.01, None))
    logged *= mask[:, None]
    d_max = onsets.shape[-1] - FSMP - NSAMPLES
    cols = FSMP + np.clip(tt[idx].T, 0, d_max) + np.arange(len(idx))
    return np.exp(np.take_along_axis(logged, cols, axis=1).sum(0) / available)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_migrate_detect_batch_matches_jax_vmap(dtype):
    onsets, mask, available = _windows(3, 3, dtype=dtype)
    tt = _table(4, 10 * 9 * 8)
    n_real = tt.shape[0] - 20
    ref = [np.asarray(x) for x in j_ops.migrate.migrate_detect_batch(
        onsets, tt, mask, available, FSMP, NSAMPLES, n_nodes_real=n_real)]
    got = ops.migrate_detect_batch(
        torch.from_numpy(onsets), torch.from_numpy(tt),
        torch.from_numpy(mask), torch.from_numpy(available), FSMP, NSAMPLES,
        n_nodes_real=n_real)
    rtol, rtol_n = TOL[dtype]
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=rtol)
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=rtol_n)
    assert got[2].dtype == torch.int32 and got[0].dtype == torch.from_numpy(
        onsets).dtype
    for b in range(len(onsets)):
        at = _coa_at(onsets[b], tt, mask[b], available[b], got[2][b].numpy())
        np.testing.assert_allclose(at, ref[0][b], rtol=max(rtol, 2e-6))
        single = ops.migrate_detect(
            torch.from_numpy(onsets[b]), torch.from_numpy(tt),
            torch.from_numpy(mask[b]), float(available[b]), FSMP, NSAMPLES,
            n_nodes_real=n_real)
        for part, whole in zip(single, got):
            assert torch.equal(part, whole[b])
    # The plain module's batch is the same function on CPU tensors
    plain = ops.migrate.migrate_detect_batch(
        torch.from_numpy(onsets), torch.from_numpy(tt),
        torch.from_numpy(mask), torch.from_numpy(available), FSMP, NSAMPLES,
        n_nodes_real=n_real)
    assert all(torch.equal(a, b) for a, b in zip(plain, got))


@pytest.mark.parametrize("n_total,n_nodes_real,node_offset", [
    (150, 130, 0),
    (150, 200, 100),
    (150, 180, 100),
    (150, 100, 100),  # a slab of padding only
])
def test_routed_detect_reduce_slab_matches_jax(n_total, n_nodes_real,
                                               node_offset):
    onsets, mask, available = _windows(5, 1)
    tt = _table(6, n_total)
    ref = [np.asarray(x) for x in j_ops.detect_reduce(
        onsets[0], tt, mask[0], available[0], FSMP, NSAMPLES, n_nodes_real,
        tile=64, node_offset=node_offset)]
    got = [x.numpy() for x in ops.detect_reduce(
        torch.from_numpy(onsets[0]), torch.from_numpy(tt),
        torch.from_numpy(mask[0]), float(available[0]), FSMP, NSAMPLES,
        n_nodes_real, tile=64, node_offset=node_offset)]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_routed_migrate_map_matches_jax(dtype):
    onsets, mask, available = _windows(7, 1, dtype=dtype)
    tt = _table(8, 300, high=LSMP + 10)  # some traveltimes past the block
    ref = np.asarray(j_ops.migrate_map(onsets[0], tt, mask[0], available[0],
                                       FSMP, NSAMPLES, tile=128))
    got = ops.migrate_map(torch.from_numpy(onsets[0]), torch.from_numpy(tt),
                          torch.from_numpy(mask[0]), float(available[0]),
                          FSMP, NSAMPLES, tile=128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL[dtype][0])
    found = [np.asarray(x) for x in j_ops.find_max_coa(ref)]
    mine = [x.numpy() for x in ops.find_max_coa(got)]
    np.testing.assert_allclose(mine[0], found[0], rtol=TOL[dtype][0])
    np.testing.assert_allclose(mine[1], found[1], rtol=TOL[dtype][1])
    np.testing.assert_array_equal(mine[2], found[2])


@pytest.mark.parametrize("transform", ["energy", "abs", "env",
                                       "env_squared"])
def test_signal_transform_matches_jax(transform):
    data = np.random.default_rng(9).normal(size=(3, 257))
    ref = np.asarray(j_ops.signal_transform(data, transform))
    got = ops.signal_transform(torch.from_numpy(data), transform)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    assert ops.DEFAULT_TILE == j_ops.DEFAULT_TILE


def test_routed_refuses_a_bad_tile():
    onsets, mask, available = _windows(1, 1)
    with pytest.raises(ValueError, match="tile"):
        ops.migrate_detect(torch.from_numpy(onsets[0]),
                           torch.from_numpy(_table(1, 64)),
                           torch.from_numpy(mask[0]), 5.0, FSMP, NSAMPLES,
                           tile=0)


def test_flat_table_detector_plan_and_cache():
    """The detector the CUDA route builds for a flat table: K3 v2 takes
    its plan of runs of 256 flat nodes, traveltimes past the block are
    clamped as the plain versions clamp them, K3's arithmetic on its
    table (the flat tiles' reference and combine) gives the JAX max and
    first flat argmax, and the cache keys on the table's identity."""

    onsets, mask, available = _windows(11, 1)
    tt_np = _table(12, 700, high=LSMP + 25)
    tt = torch.from_numpy(tt_np)
    routed.clear_cache()
    t_len = onsets.shape[-1]
    found = routed.detector(tt, 650, t_len, FSMP, NSAMPLES, torch.float32,
                            torch.device("cpu"))
    assert isinstance(found, cuda_migrate.CudaDetectGlobal)
    assert found.v2_refusal is None and found.n_nodes == 650
    assert found.tile == 256
    np.testing.assert_array_equal(found.perm.numpy()[:650], np.arange(650))
    assert int(found.tt.max()) == t_len - FSMP - NSAMPLES
    assert routed.detector(tt, 650, t_len, FSMP, NSAMPLES, torch.float32,
                           torch.device("cpu")) is found
    onsets_t = torch.from_numpy(onsets[0])
    mask_t = torch.from_numpy(mask[0])
    onsets_log, inv = found.prepare(onsets_t, mask_t, float(available[0]))
    parts = cuda_migrate.detect_reduce_flat_reference(
        onsets_log, found.tt, inv, FSMP, NSAMPLES)
    max_coa, max_idx, _ = cuda_migrate.combine_flat_tiles(*parts)
    ref = [np.asarray(x) for x in j_ops.detect_reduce(
        onsets[0], tt_np, mask[0], available[0], FSMP, NSAMPLES, 650)]
    np.testing.assert_allclose(max_coa.numpy(), ref[0], rtol=1e-5)
    at = _coa_at(onsets[0], tt_np, mask[0], available[0], max_idx.numpy())
    np.testing.assert_allclose(at, ref[0], rtol=2e-6)
    tt.add_(0)  # an in-place write: a new version, a new plan
    assert routed.detector(tt, 650, t_len, FSMP, NSAMPLES, torch.float32,
                           torch.device("cpu")) is not found
    routed.clear_cache()


def test_compute_traveltimes_method_has_no_default():
    from quakemigrate_tpu.lut import compute_traveltimes as j_ct
    from quakemigrate_torch.lut import compute_traveltimes as ct

    for fn in (ct, j_ct):
        param = inspect.signature(fn).parameters["method"]
        assert param.default is inspect.Parameter.empty
    with pytest.raises(TypeError, match="method"):
        ct({}, {})


def _old_lut_file(tmp_path):
    """The old-format file of tests/test_update_lut.py."""

    from test_update_lut import _make_current_lut

    lut = _make_current_lut()
    old_state = dict(lut.__dict__)
    old_state["maps"] = {
        station: {f"TIME_{ph}": tt for ph, tt in tables.items()}
        for station, tables in old_state.pop("traveltimes").items()
    }
    old_state["_cell_size"] = old_state.pop("_node_spacing")
    old_state["_cell_count"] = old_state.pop("_node_count")
    del old_state["phases"], old_state["fraction_tt"]
    old_file = tmp_path / "old.LUT"
    with open(old_file, "wb") as f:
        pickle.dump(old_state, f, 4)
    return old_file


def test_update_lut_matches_jax(tmp_path):
    from quakemigrate_tpu.io import read_lut as j_read_lut
    from quakemigrate_tpu.lut import update_lut as j_update_lut
    from quakemigrate_torch.io import read_lut
    from quakemigrate_torch.lut import update_lut

    old_file = _old_lut_file(tmp_path)
    j_update_lut(str(old_file), str(tmp_path / "jax.LUT"))
    update_lut(str(old_file), str(tmp_path / "port.LUT"))
    want, got = j_read_lut(str(tmp_path / "jax.LUT")), read_lut(
        str(tmp_path / "port.LUT"))
    assert got.phases == want.phases == ["P", "S"]
    assert got.fraction_tt == want.fraction_tt == 0.1
    for attr in ("node_count", "node_spacing", "ll_corner", "ur_corner"):
        np.testing.assert_array_equal(getattr(got, attr),
                                      getattr(want, attr))
    assert got.grid_proj.definition() == want.grid_proj.definition()
    assert got.coord_proj.definition() == want.coord_proj.definition()
    for column in ("Name", "Latitude", "Longitude", "Elevation"):
        np.testing.assert_array_equal(
            got.station_data[column],
            want.station_data[column].to_numpy())
    np.testing.assert_array_equal(got.serve_traveltimes(100),
                                  want.serve_traveltimes(100))


@pytest.mark.parametrize("encoding", [10, 11])
@pytest.mark.parametrize("spread", [3, 300, 40_000, 2**28])
def test_steim_py_matches_the_c_codec(encoding, spread):
    from quakemigrate_torch.core import steim_decode, steim_encode, steim_py

    rng = np.random.default_rng(spread)
    samples = np.cumsum(rng.integers(-spread, spread, size=900)).astype(
        np.int32)
    nframes = 7
    try:
        n, frames = steim_encode(samples, 5, nframes, encoding)
    except ValueError:
        out = np.zeros(nframes * 64, dtype=np.uint8)
        assert steim_py.encode(samples, 5, out, nframes, encoding)[0] == -1
        return
    out = np.zeros(nframes * 64, dtype=np.uint8)
    n_py, used = steim_py.encode(samples, 5, out, nframes, encoding)
    assert (n_py, out[:used * 64].tobytes()) == (n, frames)
    decoded = np.empty(n, dtype=np.int32)
    assert steim_py.decode(np.frombuffer(frames, np.uint8), used, n,
                           decoded, encoding) == n
    np.testing.assert_array_equal(decoded, samples[:n])
    np.testing.assert_array_equal(steim_decode(frames, n, encoding), decoded)


@pytest.mark.parametrize("name", ["overlapping_sta_lta_py",
                                  "centred_sta_lta_py"])
def test_standalone_stalta_matches_jax(name):
    from quakemigrate_tpu.signal.onsets import stalta as j_stalta
    from quakemigrate_torch.signal.onsets import stalta

    signal = np.random.default_rng(13).gamma(2.0, 1.0, size=(3, 2000))
    ref = getattr(j_stalta, name)(signal, 20, 200)
    got = getattr(stalta, name)(signal, 20, 200, device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("maps", [
    {"P": "*Z", "S": "*[N,E]"},
    {"P": "*Z", "S": "*[1,2]"},
    {"P": "*[Z,3]", "S": "*[N,E,1,2]"},
    {"P": "*Z", "S": "*[N,E,1,2,3]"},
])
def test_phase_component_strings_match_jax(maps):
    assert (util.get_phase_component_strings(maps)
            == j_util.get_phase_component_strings(maps))


@pytest.mark.parametrize("x", [0.0, 16436.5123456, 19000.987654321,
                               -3.25])
def test_date_formatter_matches_jax(x):
    for fmt, precision in (("%H:%M:%S.{ms}", 2), ("%Y-%m-%d %H:%M:%S.{ms}",
                                                   6)):
        assert (util.DateFormatter(fmt, precision)(x)
                == j_util.DateFormatter(fmt, precision)(x))


def test_util_helpers_match_jax(tmp_path):
    util.make_directories(tmp_path / "run", subdir="locate/events")
    assert (tmp_path / "run" / "locate" / "events").is_dir()
    np.testing.assert_array_equal(util.gaussian_3d(5, 4, 3, [1.0, 2.0, 0.5]),
                                  j_util.gaussian_3d(5, 4, 3,
                                                     [1.0, 2.0, 0.5]))
    assert (str(util.ChannelNameException("XX.ST01..HHQ"))
            == str(j_util.ChannelNameException("XX.ST01..HHQ")))
    assert (str(util.ArchiveFDSNException("HTTP 500"))
            == str(j_util.ArchiveFDSNException("HTTP 500")))
    assert issubclass(util.ArchiveFDSNException, util.QMError)

    @util.timeit("info", unused=True)
    def twice(x):
        return 2 * x

    assert twice(3) == 6


def test_stream_extend_and_clear():
    from quakemigrate_torch.seis import Stream, Trace

    traces = [Trace(np.arange(5.0), {"station": s}) for s in ("A", "B")]
    st = Stream()
    assert st.extend(traces) is st and len(st) == 2
    assert st.clear() is st and len(st) == 0


def test_csv_readers_take_sep_and_refuse_other_options(tmp_path):
    from quakemigrate_torch.io import read_stations, read_vmodel

    (tmp_path / "st.csv").write_text(
        "Name;Latitude;Longitude;Elevation\nA;64.1;-17.2;0.5\n")
    got = read_stations(tmp_path / "st.csv", sep=";")
    assert got["Name"].tolist() == ["A"] and got["Elevation"][0] == -0.5
    with pytest.raises(TypeError, match="usecols"):
        read_stations(tmp_path / "st.csv", usecols=[0])
    (tmp_path / "vm.csv").write_text("Depth;Vp\n0;5.0\n")
    assert read_vmodel(tmp_path / "vm.csv", sep=";")["Vp"].tolist() == [5.0]


def test_reexports_and_core_entry_points():
    import quakemigrate_torch
    from quakemigrate_torch import core, io, lut, seis
    from quakemigrate_torch.io.core import stations
    from quakemigrate_torch.seis import mseed, steim
    from quakemigrate_torch.signal import scan

    assert quakemigrate_torch.read_nlloc is lut.read_nlloc
    assert io.stations is stations
    assert scan.DEFAULT_TILE == ops.DEFAULT_TILE == 4096
    assert core.native_available()
    for name in ("steim_decode", "steim_encode", "steim_decode_records",
                 "steim_encode_records"):
        assert getattr(core, name) is getattr(steim, name)
    assert mseed.steim_encode is steim.steim_encode
    assert seis.Stream.extend and seis.Stream.clear


def test_event_add_picks_takes_pick_df():
    from quakemigrate_torch.io.event import Event

    event = Event.__new__(Event)
    event.add_picks(pick_df="table", gaussfits={})
    assert event.picks == {"df": "table", "gaussfits": {}}
