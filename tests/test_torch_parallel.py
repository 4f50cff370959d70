# -*- coding: utf-8 -*-
"""
quakemigrate_torch.parallel on a mesh of 8 CPU devices
(``make_mesh([torch.device("cpu")] * 8)``) against the JAX package's
parallel on its 8 virtual CPU devices (tests/conftest.py) and against the
port's unsharded functions, on seeded numpy inputs:

- the counterparts of tests/test_parallel.py: sharded against unsharded
  with 1000 nodes, which do not divide by 8 slabs; argmax ties across
  slab boundaries, resolved to the smallest flat index; the "batch"
  axis;
- each ``make_sharded_*`` against the port's unsharded function: the max
  and argmax equal, the normalised max within 1e-13 (float64) or 2e-6
  (float32) relative (the cross-slab sum rounds in its own order), as
  tests/test_scan_mesh.py holds the JAX mesh to its single device; and
  against the JAX function of the same name: the argmax equal, the max
  within 1e-15 (float64; torch's and XLA's exp round apart by an ulp at
  some samples) or 2e-6 (float32) and the normalised max within 2e-6,
  the bounds of the port's unsharded parity tests; the MXU forms, the
  port on its plan's
  plain version and JAX in interpret mode (its int8 3-word table encodes
  each log onset within 7.7e-7), within 2e-6 and argmax tie-consistent,
  and the port's MXU form against its own unsharded plan exactly;
- ``pad_nodes_for_mesh`` byte-equal to JAX's, ``pad_mxu_plan_for_mesh``'s
  valid and perm equal to JAX's, and the cross-slab combine's tie rule.

"""

import numpy as np
import pytest
import torch

import jax

from quakemigrate_tpu import parallel as j_parallel
from quakemigrate_tpu.ops.pallas_migrate import PallasDetectMXU
from quakemigrate_torch import parallel
from quakemigrate_torch.ops import cuda_migrate, migrate
from quakemigrate_torch.ops.scan_window import detect_window_fused

torch.set_num_threads(1)

RTOL = 2e-6
RTOL64 = 1e-15
CPU = torch.device("cpu")


def _assert_vs_jax(got, ref, rtol_max=RTOL):
    """Against the JAX function: the argmax equal, the max within
    ``rtol_max`` and the normalised max within RTOL."""

    np.testing.assert_allclose(got[0], ref[0], rtol=rtol_max)
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL)
    np.testing.assert_array_equal(got[2], ref[2])


def _mesh(shape=None):
    if shape is None:
        return parallel.make_mesh([CPU] * 8)
    return parallel.make_mesh([CPU] * 8, axis_names=("batch", "grid"),
                              shape=shape)


def _j_mesh(shape=None):
    if shape is None:
        return j_parallel.make_mesh(jax.devices())
    return j_parallel.make_mesh(jax.devices(), axis_names=("batch", "grid"),
                                shape=shape)


def _np(outs):
    return [x.numpy() if torch.is_tensor(x) else np.asarray(x) for x in outs]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's problem."""

    rng = np.random.default_rng(21)
    n_onsets, t_samples, fsmp, lsmp = 6, 150, 12, 40
    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, t_samples))
    tt = rng.integers(0, 35, size=(1000, n_onsets)).astype(np.int32)
    return onsets, tt, fsmp, t_samples - fsmp - lsmp


def _detect_both(onsets, tt, mask, available, fsmp, nsamples, shape=None,
                 batch_axis=None):
    """The port's and JAX's make_sharded_detect on their meshes."""

    n_grid = 8 if shape is None else shape[1]
    padded, n_real = parallel.pad_nodes_for_mesh(tt, n_grid, tile=64)
    got = parallel.make_sharded_detect(
        _mesh(shape), fsmp, nsamples, n_real, tile=64,
        batch_axis=batch_axis)(onsets, padded, mask, available)
    ref = j_parallel.make_sharded_detect(
        _j_mesh(shape), fsmp, nsamples, n_real, tile=64,
        batch_axis=batch_axis)(onsets, padded, mask, available)
    return _np(got), _np(ref)


def test_sharded_matches_single_device(problem):
    onsets, tt, fsmp, nsamples = problem
    mask = np.ones(onsets.shape[0])
    got, ref = _detect_both(onsets, tt, mask, float(len(mask)), fsmp,
                            nsamples)
    single = _np(migrate.migrate_detect(*_t(onsets, tt, mask),
                                        float(len(mask)), fsmp, nsamples,
                                        tile=64))
    np.testing.assert_array_equal(got[0], single[0])
    np.testing.assert_allclose(got[1], single[1], rtol=1e-13)
    np.testing.assert_array_equal(got[2], single[2])
    _assert_vs_jax(got, ref, rtol_max=RTOL64)


def test_sharded_tie_breaking_across_shards(problem):
    """Duplicate traveltime rows force exact ties in different slabs."""

    onsets, tt, fsmp, nsamples = problem
    tt = tt.copy()
    tt[900] = tt[50]
    mask = np.ones(onsets.shape[0])
    got, ref = _detect_both(onsets, tt, mask, float(len(mask)), fsmp,
                            nsamples)
    single = _np(migrate.migrate_detect(*_t(onsets, tt, mask),
                                        float(len(mask)), fsmp, nsamples,
                                        tile=64))
    np.testing.assert_array_equal(got[2], single[2])
    np.testing.assert_array_equal(got[2], ref[2])
    assert not np.any(got[2] == 900)


def test_batched_sharded(problem):
    """2-D mesh: batch of scan windows x grid slabs."""

    onsets, tt, fsmp, nsamples = problem
    rng = np.random.default_rng(5)
    batch = np.stack([onsets, rng.gamma(2.0, 1.5, onsets.shape)])
    masks = np.ones((2, onsets.shape[0]))
    masks[1, -1] = 0.0
    avail = masks.sum(axis=1)
    got, ref = _detect_both(batch, tt, masks, avail, fsmp, nsamples,
                            shape=(2, 4), batch_axis="batch")
    for b in range(2):
        single = _np(migrate.migrate_detect(*_t(batch[b], tt, masks[b]),
                                            avail[b], fsmp, nsamples,
                                            tile=64))
        np.testing.assert_array_equal(got[0][b], single[0])
        np.testing.assert_allclose(got[1][b], single[1], rtol=1e-13)
        np.testing.assert_array_equal(got[2][b], single[2])
        _assert_vs_jax([g[b] for g in got], [r[b] for r in ref],
                       rtol_max=RTOL64)


@pytest.mark.parametrize("n_nodes,n_shards,tile", [
    (1000, 8, 64), (1024, 8, 64), (5, 3, 4), (4096, 2, 4096)])
def test_pad_nodes_for_mesh_equals_jax(n_nodes, n_shards, tile):
    tt = np.random.default_rng(n_nodes).integers(
        0, 99, size=(n_nodes, 3)).astype(np.int32)
    got, n_got = parallel.pad_nodes_for_mesh(tt, n_shards, tile)
    ref, n_ref = j_parallel.pad_nodes_for_mesh(tt, n_shards, tile)
    assert n_got == n_ref == n_nodes
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


def test_combine_ties_take_the_smaller_flat_index():
    """A max attained in two slabs (and twice in one sample) goes to the
    smaller flat index, whatever the slabs' order."""

    mx = torch.tensor([[1.0, 2.0, 3.0], [1.0, 5.0, 3.0], [0.5, 5.0, 3.0]])
    idx = torch.tensor([[40, 7, 90], [12, 300, 88], [3, 250, 89]],
                       dtype=torch.int32)
    sm = torch.ones(3, 3)
    parts = [(m, i, s) for m, i, s in zip(mx, idx, sm)]
    gmax, gnorm, gidx = parallel.combine_slabs(parts, 10, CPU)
    assert gmax.tolist() == [1.0, 5.0, 3.0]
    assert gidx.tolist() == [12, 250, 88] and gidx.dtype == torch.int32
    np.testing.assert_allclose(gnorm.numpy(), gmax.numpy() * 10 / 3)
    assert parallel.combine_slabs(parts[::-1], 10, CPU)[2].tolist() == [
        12, 250, 88]


def test_sharded_marginalise_matches_jax(problem):
    onsets, tt, fsmp, nsamples = problem
    mask = np.ones(onsets.shape[0])
    mask[2] = 0.0
    available = float(mask.sum())
    padded, n_real = parallel.pad_nodes_for_mesh(tt, 8, tile=64)
    got = parallel.make_sharded_marginalise(_mesh(), fsmp, nsamples,
                                            tile=64)(
        onsets, padded, mask, available, 10, 37).numpy()
    ref = np.asarray(j_parallel.make_sharded_marginalise(
        _j_mesh(), fsmp, nsamples, tile=64)(onsets, padded, mask, available,
                                            10, 37))
    assert got.shape == ref.shape == (padded.shape[0],)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    single = migrate.migrate_marginalise(*_t(onsets, tt, mask), available,
                                         fsmp, nsamples, 10, 37).numpy()
    np.testing.assert_array_equal(got[:n_real], single)


def _fused_problem(seed=3, n_nodes=500):
    """tests/test_scan_mesh.py's fused-window problem (float32)."""

    rng = np.random.default_rng(seed)
    n_slots, c_max, fsmp, nsamples, lsmp = 6, 3, 32, 100, 48
    t = fsmp + nsamples + lsmp
    channels = rng.normal(size=(n_slots, c_max, t)).astype(np.float32)
    chan_mask = np.ones((n_slots, c_max), dtype=np.float32)
    chan_mask[:3, 1:] = 0.0
    slot_mask = np.ones(n_slots, dtype=np.float32)
    slot_mask[4] = 0.0
    nsta = np.full(n_slots, 5, dtype=np.int32)
    nlta = np.full(n_slots, 21, dtype=np.int32)
    nkurt = np.full(n_slots, 26, dtype=np.int32)
    tt = rng.integers(0, lsmp, size=(n_nodes, n_slots)).astype(np.int32)
    return dict(channels=channels, chan_mask=chan_mask, slot_mask=slot_mask,
                nsta=nsta, nlta=nlta, nkurt=nkurt, tt=tt, fsmp=fsmp,
                nsamples=nsamples)


def _assert_sharded_equal(got, ref):
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL)


@pytest.mark.parametrize("kind", ["stalta", "kurtosis"])
def test_sharded_fused_matches_jax(kind):
    p = _fused_problem()
    padded, n_real = parallel.pad_nodes_for_mesh(p["tt"], 8, tile=32)
    if kind == "stalta":
        args = (p["channels"], p["chan_mask"], p["slot_mask"], p["nsta"],
                p["nlta"], padded)
        settings = ("classic", "energy", 0.5)
        make, j_make = (parallel.make_sharded_detect_fused,
                        j_parallel.make_sharded_detect_fused)
    else:
        args = (p["channels"], p["chan_mask"], p["slot_mask"], p["nkurt"],
                padded)
        settings = (3, 4, 0.5)
        make, j_make = (parallel.make_sharded_detect_fused_kurtosis,
                        j_parallel.make_sharded_detect_fused_kurtosis)
    got = _np(make(_mesh(), *settings, p["fsmp"], p["nsamples"], n_real,
                   tile=32)(*args))
    ref = _np(j_make(_j_mesh(), *settings, p["fsmp"], p["nsamples"], n_real,
                     tile=32)(*args))
    _assert_vs_jax(got, ref)
    if kind == "stalta":
        single = _np(detect_window_fused(
            *_t(*args[:5]), torch.from_numpy(p["tt"]), *settings, p["fsmp"],
            p["nsamples"], tile=32))
        _assert_sharded_equal(got, single)


def test_sharded_fused_batched_matches_jax():
    """The batched fused window on a 2 x 4 mesh: two windows and two
    inert pad windows (ones, masks 0), whose available is clamped to 1."""

    p, q = _fused_problem(3), _fused_problem(4)
    padded, n_real = parallel.pad_nodes_for_mesh(p["tt"], 4, tile=32)
    stack = [np.stack([p[k], q[k], np.full_like(p[k], fill),
                       np.full_like(p[k], fill)])
             for k, fill in (("channels", 1.0), ("chan_mask", 0.0),
                             ("slot_mask", 0.0))]
    args = (*stack, p["nsta"], p["nlta"], padded)
    common = ("classic", "energy", 0.5, p["fsmp"], p["nsamples"], n_real)
    got = _np(parallel.make_sharded_detect_fused(
        _mesh((2, 4)), *common, tile=32, batch_axis="batch")(*args))
    ref = _np(j_parallel.make_sharded_detect_fused(
        _j_mesh((2, 4)), *common, tile=32, batch_axis="batch")(*args))
    assert got[0].shape == (4, p["nsamples"])
    for b in range(2):
        _assert_vs_jax([g[b] for g in got], [r[b] for r in ref])
        single = _np(detect_window_fused(
            *_t(*(a[b] for a in stack), p["nsta"], p["nlta"]),
            torch.from_numpy(p["tt"]),
            "classic", "energy", 0.5, p["fsmp"], p["nsamples"], tile=32))
        _assert_sharded_equal([g[b] for g in got], single)


def _mxu_problem():
    """tests/test_scan_mesh.py's MXU problem: an 8 x 6 x 5 grid in 8
    brick tiles of 64 nodes."""

    rng = np.random.default_rng(11)
    nx, ny, nz = 8, 6, 5
    p = _fused_problem(11)
    p["chan_mask"][:] = 1.0
    p["chan_mask"][2, 1:] = 0.0
    x, y, z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    tts = [np.rint(np.sqrt((x - rng.uniform(0, nx)) ** 2
                           + (y - rng.uniform(0, ny)) ** 2 + z**2) * 3
                   ).astype(np.int32) for _ in range(6)]
    p["tt"] = np.clip(np.stack(tts, -1).reshape(-1, 6), 0, 48)
    p["node_count"] = (nx, ny, nz)
    return p


def _coa_at(p, idx, kind):
    """Float64 coalescence of node idx[t] at sample t of the fused
    window (the front end in float64 on the CPU)."""

    from quakemigrate_torch.ops.scan_window import (
        fused_kurtosis_onsets,
        fused_onsets,
    )

    blocks = [torch.from_numpy(p[k]).double() if p[k].dtype == np.float32
              else torch.from_numpy(p[k])
              for k in ("channels", "chan_mask", "slot_mask")]
    if kind == "stalta":
        combined, available = fused_onsets(
            *blocks, *_t(p["nsta"], p["nlta"]), "classic", "energy", 0.5)
    else:
        combined, available = fused_kurtosis_onsets(
            *blocks, torch.from_numpy(p["nkurt"]), 3, 4, 0.5)
    logged = (torch.log(torch.clamp(combined, min=0.01))
              * blocks[2][:, None]).numpy()
    t = np.arange(len(idx))
    cols = p["fsmp"] + p["tt"][idx].T + t
    return np.exp(np.take_along_axis(logged, cols, axis=1).sum(0)
                  / float(available))


@pytest.mark.parametrize("kind,n_devices", [
    ("stalta", 8), ("kurtosis", 8), ("stalta", 3)])
def test_sharded_fused_mxu_matches_jax(kind, n_devices):
    """On 8 devices a tile a slab; on 3 the 8 tiles padded with a dead
    tile to 3 a slab."""

    p = _mxu_problem()
    n_nodes = int(np.prod(p["node_count"]))
    kernel = cuda_migrate.CudaDetect(p["tt"], p["node_count"], p["fsmp"],
                                     p["nsamples"], CPU, tile=64,
                                     brick_shape=(4, 4, 4))
    j_kernel = PallasDetectMXU(p["tt"], p["node_count"], p["fsmp"],
                               p["nsamples"], tile=64, brick_shape=(4, 4, 4))
    plan = parallel.pad_mxu_plan_for_mesh(kernel, n_devices)
    j_plan = j_parallel.pad_mxu_plan_for_mesh(j_kernel, n_devices)
    assert kernel.plan.n_tiles == 8
    assert plan[0].shape[0] == -(-8 // n_devices) * n_devices
    # The same tiles and dead tiles (the MXU plan aligns its base apart)
    np.testing.assert_array_equal(plan[2], j_plan[2][..., 0])
    np.testing.assert_array_equal(plan[3], j_plan[3])
    if kind == "stalta":
        block = (p["channels"], p["chan_mask"], p["slot_mask"], p["nsta"],
                 p["nlta"])
        settings = ("classic", "energy", 0.5)
        make, j_make = (parallel.make_sharded_detect_fused_mxu,
                        j_parallel.make_sharded_detect_fused_mxu)
    else:
        block = (p["channels"], p["chan_mask"], p["slot_mask"], p["nkurt"])
        settings = (3, 4, 0.5)
        make, j_make = (parallel.make_sharded_detect_fused_kurtosis_mxu,
                        j_parallel.make_sharded_detect_fused_kurtosis_mxu)
    common = (p["fsmp"], p["nsamples"], n_nodes)
    mesh = parallel.make_mesh([CPU] * n_devices)
    j_mesh = j_parallel.make_mesh(jax.devices()[:n_devices])
    got = _np(make(mesh, *settings, *common, tile=64,
                   r_spans=kernel.plan.r_spans)(*block, *plan))
    ref = _np(j_make(j_mesh, *settings, *common, tile=64,
                     r_spans=j_kernel.r_spans, interpret=True)(
        *block, *j_plan))
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL)
    assert (got[2] == ref[2]).mean() > 0.99
    np.testing.assert_allclose(_coa_at(p, got[2], kind), ref[0], rtol=RTOL)

    # Against the port's unsharded plan: the max bit for bit, the argmax
    # a node of the max
    front = (parallel.stalta_front_end if kind == "stalta"
             else parallel.kurtosis_front_end)(*settings)
    tensors = _t(*block)
    combined, available = front(*tensors)
    max_coa, max_idx, coa_sum = kernel.reduce(combined, tensors[2],
                                              available)
    np.testing.assert_array_equal(got[0], max_coa.numpy())
    np.testing.assert_allclose(got[1], (max_coa * n_nodes / coa_sum).numpy(),
                               rtol=RTOL)
    assert (got[2] == max_idx.numpy()).mean() > 0.99
    np.testing.assert_allclose(_coa_at(p, got[2], kind), got[0], rtol=RTOL)
