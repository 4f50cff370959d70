# -*- coding: utf-8 -*-
"""
Locate's marginalisation (pass 2): the plain
``quakemigrate_torch.ops.migrate.migrate_marginalise`` against the JAX
``migrate_marginalise`` on seeded inputs, and M1, its CUDA kernel
(``csrc/migrate_marginalise.cu``), through a numpy emulation of the
kernel's arithmetic on the detect plan. The kernel itself runs only on
the card: chip_smoke.py holds it to the plain version there.

- the plain version against JAX's, within 1e-5 of the map's maximum
  (both sum the onsets in order in float32; the samples are summed in
  other orders): windows at the start, the middle and the end of the
  scan, one of one sample, and one of none;
- the emulation of M1 (per node of the plan and chunk of M1_CHUNK
  samples: onsets summed in order in float32, exp of the sum times
  1 / available, each lane's samples, the warp's shuffle tree, the store
  through perm; the chunks' sums added in chunk order) against the plain
  version within 1e-5 of the maximum, every real node written once, on
  windows of one chunk and of several;
- M1's wrapper raising on CPU tensors, on a window outside the scan and
  on an onset block too short for the plan, and the chunk table it hands
  the kernel;
- its entry in the C API table.

"""

import ctypes

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.migrate import (
    migrate_marginalise as j_migrate_marginalise,
)
from quakemigrate_torch import _build
from quakemigrate_torch.ops.cuda_migrate import (
    M1_CHUNK,
    CudaDetect,
    DetectPlan,
    migrate_marginalise_cuda,
)
from quakemigrate_torch.ops.migrate import _prepare_onsets, migrate_marginalise

torch.set_num_threads(1)

NODE_COUNT = (9, 8, 7)
N_ONSETS = 6
FSMP, NSAMPLES, LSMP = 20, 90, 40
RTOL_OF_MAX = 1e-5


# A scan long enough for M1 to split a window into chunks
LONG_NSAMPLES = 3 * M1_CHUNK + 40


def _make_inputs(nsamples, seed):
    rng = np.random.default_rng(seed)
    n_nodes = int(np.prod(NODE_COUNT))
    t_len = FSMP + nsamples + LSMP
    onsets = rng.uniform(0.2, 6.0, size=(N_ONSETS, t_len))
    traveltimes = rng.integers(0, LSMP + 1, size=(n_nodes, N_ONSETS))
    mask = np.ones(N_ONSETS)
    mask[3] = 0.0  # one dead onset row
    return {"onsets": onsets.astype(np.float32),
            "traveltimes": traveltimes.astype(np.int32), "mask": mask,
            "available": float(mask.sum()), "nsamples": nsamples}


@pytest.fixture(scope="module")
def inputs():
    return _make_inputs(NSAMPLES, 1313)


@pytest.fixture(scope="module")
def long_inputs():
    return _make_inputs(LONG_NSAMPLES, 1314)


def _plain(inputs, start, length):
    return migrate_marginalise(
        torch.from_numpy(inputs["onsets"]),
        torch.from_numpy(inputs["traveltimes"]),
        torch.from_numpy(inputs["mask"].astype(np.float32)),
        inputs["available"], FSMP, inputs["nsamples"], start, length,
    ).numpy()


WINDOWS = [(0, 25), (30, 31), (NSAMPLES - 17, 17), (44, 1)]


@pytest.mark.parametrize("start, length", WINDOWS)
def test_plain_equals_jax(inputs, start, length):
    got = _plain(inputs, start, length)
    want = np.asarray(j_migrate_marginalise(
        inputs["onsets"], inputs["traveltimes"],
        inputs["mask"].astype(np.float32), np.float32(inputs["available"]),
        FSMP, NSAMPLES, start, length, tile=128,
    ))
    assert got.shape == want.shape == (len(inputs["traveltimes"]),)
    assert np.abs(got - want).max() <= RTOL_OF_MAX * np.abs(want).max()


def test_plain_empty_window_is_zero(inputs):
    assert not _plain(inputs, 10, 0).any()


@pytest.mark.parametrize("start, length", [(-1, 5), (0, NSAMPLES + 1),
                                           (NSAMPLES - 3, 4)])
def test_plain_refuses_window_outside_scan(inputs, start, length):
    with pytest.raises(ValueError, match="inside"):
        _plain(inputs, start, length)


def _emulate_m1(inputs, plan, start, length):
    """M1's arithmetic in numpy float32 on the plan: out[perm[n]] for
    each real node n, and the count of writes per flat node."""

    logged = _prepare_onsets(
        torch.from_numpy(inputs["onsets"]),
        torch.from_numpy(inputs["mask"].astype(np.float32)),
    ).numpy().astype(np.float32)
    inv = np.float32(1.0) / np.float32(inputs["available"])
    n_tiles, n_onsets, tile = plan.fine.shape
    n_chunks = max(1, -(-length // M1_CHUNK))
    partial = np.zeros((n_chunks, plan.n_nodes), np.float32)
    writes = np.zeros(plan.n_nodes, int)
    t = np.arange(length)
    for i in range(n_tiles):
        real = np.flatnonzero(plan.valid[i])
        acc = np.zeros((real.size, length), np.float32)
        for o in range(n_onsets):  # onsets in order, in float32
            cols = (FSMP + start + plan.base[i, o]
                    + plan.fine[i, o, real][:, None] + t)
            acc += logged[o][cols]
        coa = np.exp(acc * inv).astype(np.float32)
        flat = plan.perm[i * tile + real]
        # One block a chunk: each lane adds its samples lane + 32 k of the
        # chunk in order, then the warp's xor shuffle tree
        for c in range(n_chunks):
            lanes = np.zeros((real.size, 32), np.float32)
            for s in range(c * M1_CHUNK, min((c + 1) * M1_CHUNK, length)):
                lanes[:, s % 32] += coa[:, s]
            for d in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[:, np.arange(32) ^ d]
            partial[c, flat] = lanes[:, 0]
        writes[flat] += 1
    if n_chunks == 1:
        return partial[0], writes
    out = np.zeros(plan.n_nodes, np.float32)
    for c in range(n_chunks):  # the chunks' sums in chunk order
        out += partial[c]
    return out, writes


@pytest.mark.parametrize("start, length", WINDOWS + [(7, 70)])
def test_m1_emulation_equals_plain(inputs, start, length):
    plan = DetectPlan(inputs["traveltimes"], NODE_COUNT, tile=64,
                      brick_shape=(4, 4, 4))
    got, writes = _emulate_m1(inputs, plan, start, length)
    assert (writes == 1).all()  # every real node once, padding never
    want = _plain(inputs, start, length)
    assert np.abs(got - want).max() <= RTOL_OF_MAX * np.abs(want).max()


@pytest.mark.parametrize("start, length", [
    (0, LONG_NSAMPLES),  # four chunks, the last one partial
    (37, 2 * M1_CHUNK + 1),  # three chunks, the last of one sample
    (100, M1_CHUNK),  # exactly one chunk
])
def test_m1_emulation_in_chunks_equals_plain(long_inputs, start, length):
    plan = DetectPlan(long_inputs["traveltimes"], NODE_COUNT, tile=64,
                      brick_shape=(4, 4, 4))
    got, writes = _emulate_m1(long_inputs, plan, start, length)
    assert (writes == 1).all()
    want = _plain(long_inputs, start, length)
    assert np.abs(got - want).max() <= RTOL_OF_MAX * np.abs(want).max()


def _detector(inputs):
    return CudaDetect(inputs["traveltimes"], NODE_COUNT, FSMP, NSAMPLES,
                      "cpu", tile=64, brick_shape=(4, 4, 4))


def test_m1_wrapper_raises_on_cpu_tensors(inputs):
    detector = _detector(inputs)
    onsets_log, inv = detector.prepare(
        torch.from_numpy(inputs["onsets"]),
        torch.from_numpy(inputs["mask"].astype(np.float32)),
        inputs["available"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        detector.marginalise(onsets_log, inv, 0, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        migrate_marginalise_cuda(
            onsets_log, detector.base, detector.fine, detector.valid,
            detector.perm, inv, FSMP, NSAMPLES, 0, 10, detector.n_nodes,
            detector._max_shift)


@pytest.mark.parametrize("start, length, t_cut, match", [
    (NSAMPLES - 3, 4, 0, "inside"),
    (0, 10, 1, "too short"),
])
def test_m1_wrapper_checks_window_and_onsets(inputs, start, length, t_cut,
                                             match, monkeypatch):
    """The checks before the launch: the wrapper is made to take the CPU
    tensors as if they were on the card (the device check passed), so
    that the window and onset-length checks are reached."""

    from quakemigrate_torch.ops import cuda_migrate as cm

    detector = _detector(inputs)
    onsets = torch.from_numpy(inputs["onsets"])
    onsets_log, inv = detector.prepare(
        onsets, torch.from_numpy(inputs["mask"].astype(np.float32)),
        inputs["available"])
    onsets_log = onsets_log[:, :onsets_log.shape[1] - t_cut].contiguous()
    monkeypatch.setattr(cm, "check_kernel_args", lambda *a, **k: (
        N_ONSETS, onsets_log.shape[1], detector.base.shape[0],
        detector.tile))
    monkeypatch.setattr(cm, "launch_kernel", lambda *a: pytest.fail(
        "launched past a failed check"))
    with pytest.raises(ValueError, match=match):
        migrate_marginalise_cuda(
            onsets_log, detector.base, detector.fine, detector.valid,
            detector.perm, inv, FSMP, NSAMPLES, start, length,
            detector.n_nodes, detector._max_shift)


@pytest.mark.parametrize("length, n_chunks", [
    (0, 1), (M1_CHUNK, 1), (M1_CHUNK + 1, 2), (3 * M1_CHUNK + 40, 4),
])
def test_m1_wrapper_passes_chunk_table(long_inputs, length, n_chunks,
                                       monkeypatch):
    """The wrapper hands the kernel a [chunks, n_nodes] table where the
    window spans more than one chunk, and none where it is one chunk
    (the launch is caught, as if the tensors were on the card)."""

    from quakemigrate_torch.ops import cuda_migrate as cm

    nsamples = long_inputs["nsamples"]
    detector = CudaDetect(long_inputs["traveltimes"], NODE_COUNT, FSMP,
                          nsamples, "cpu", tile=64, brick_shape=(4, 4, 4))
    onsets_log, inv = detector.prepare(
        torch.from_numpy(long_inputs["onsets"]),
        torch.from_numpy(long_inputs["mask"].astype(np.float32)),
        long_inputs["available"])
    monkeypatch.setattr(cm, "check_kernel_args", lambda *a, **k: (
        N_ONSETS, onsets_log.shape[1], detector.base.shape[0],
        detector.tile))
    seen = []
    monkeypatch.setattr(cm, "launch_kernel", lambda *a: seen.append(a))
    migrate_marginalise_cuda(
        onsets_log, detector.base, detector.fine, detector.valid,
        detector.perm, inv, FSMP, nsamples, 0, length, detector.n_nodes,
        detector._max_shift)
    (args,) = seen
    partial, rows, n_nodes = args[10:13]
    assert (rows, n_nodes) == (n_chunks, detector.n_nodes)
    assert (partial is None) == (n_chunks == 1)
    assert args[-2:] == (FSMP, length)


def test_m1_signature_entry():
    argtypes = _build.SIGNATURES["qm_migrate_marginalise"]
    p, i = ctypes.c_void_p, ctypes.c_int
    assert argtypes == [p, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                        p]
    assert (_build.CSRC_DIR / "migrate_marginalise.cu").is_file()
