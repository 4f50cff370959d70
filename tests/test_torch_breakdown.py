# -*- coding: utf-8 -*-
"""
The detect-kernel breakdown of quakemigrate_torch (ops.cuda_breakdown and
experiments/) on the CPU: the day-scale workload against the JAX
experiments' own, each ablation's plain version against a float64 numpy
brute force of its contract, FULL against the JAX MXU kernel in interpret
mode, and the host-side geometry of the resident and pipelined kernels.

The JAX breakdown kernels themselves (``_kernel``, ``_resident_kernel``,
``_deep_kernel`` of experiments/exp_kernel_breakdown.py) cannot run on
the CPU: they take no ``interpret`` argument and stage with TPU DMAs. The
CUDA kernels run only on the card (chip_smoke.py holds each against the
plain versions tested here). Float32; values at rtol 2e-6, argmax
tie-consistent.

"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.pallas_migrate import PallasDetectMXU
from quakemigrate_torch.experiments import exp_kernel_breakdown
from quakemigrate_torch.experiments.workload import workload
from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops import cuda_migrate, migrate

from test_torch_migrate import RTOL, _assert_tie_consistent, _torch, _workload

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_experiment_workload():
    """experiments/exp_vmem_sweep.py loaded by its path (numpy only; the
    experiments directory is not a package)."""

    path = REPO / "experiments" / "exp_vmem_sweep.py"
    spec = importlib.util.spec_from_file_location("_exp_vmem_sweep", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.workload


@pytest.mark.parametrize("nsamples,n_onsets,fsmp", [
    (625, 24, 500), (300, 6, 40),
])
def test_workload_equals_jax_experiments(nsamples, n_onsets, fsmp):
    dims, tt, onsets = workload(nsamples, n_onsets=n_onsets, fsmp=fsmp)
    ref_dims, ref_tt, ref_onsets = _jax_experiment_workload()(
        nsamples, n_onsets=n_onsets, fsmp=fsmp)
    assert dims == ref_dims == (71, 64, 57)
    assert tt.dtype == ref_tt.dtype and onsets.dtype == ref_onsets.dtype
    np.testing.assert_array_equal(tt, ref_tt)
    np.testing.assert_array_equal(onsets, ref_onsets)


def _small_plan(seed=1, node_count=(6, 5, 4), n_onsets=4, fsmp=5,
                nsamples=30, tile=32, brick=(4, 4, 2)):
    onsets, tt, mask, available = _workload(
        seed, node_count=node_count, n_onsets=n_onsets, fsmp=fsmp, lsmp=20,
        nsamples=nsamples,
    )
    tt[1] = tt[0]  # a tie inside a tile
    plan = cuda_migrate.DetectPlan(tt, node_count, tile=tile,
                                   brick_shape=brick)
    logged = migrate._prepare_onsets(*_torch(onsets, mask))
    inv = torch.tensor([1.0 / available], dtype=torch.float32)
    args = (logged, *_torch(plan.base, plan.fine, plan.valid), inv, fsmp,
            nsamples)
    return plan, args, available


def _brute_force(plan, logged, fsmp, nsamples, available, variant):
    """Float64 numpy of each variant's contract (the expressions of the
    TPU experiment, exp_kernel_breakdown.py:102-144, on the gather plan):
    returns (tmax, tsum, per-tile coalescence for the argmax variants)."""

    ref_log = logged.numpy().astype(np.float64)
    t = np.arange(nsamples)
    tmax, tsum, coas = [], [], []
    for i in range(plan.n_tiles):
        if variant == "nogather":
            cols = fsmp + plan.base[i][:, None] + t  # [O, S]
            acc = np.take_along_axis(ref_log, cols, axis=1).sum(0)
            tmax.append(acc)
            tsum.append(acc)
            continue
        cols = (fsmp + plan.base[i][:, None, None] + plan.fine[i][:, :, None]
                + t)  # [O, tile, S]
        acc = np.take_along_axis(
            ref_log[:, None, :].repeat(plan.tile, 1), cols, axis=2
        ).sum(0)
        if variant == "noreduce":
            tmax.append(acc[0])
            tsum.append(acc[1])
            continue
        coa = acc / available
        if variant != "noexp":
            coa = np.exp(coa)
        coa = coa * plan.valid[i][:, None]
        tmax.append(coa.max(0))
        tsum.append(coa.sum(0))
        coas.append(coa)
    return np.array(tmax), np.array(tsum), coas


@pytest.mark.parametrize("variant", cb.ABLATIONS)
def test_ablate_reference_matches_brute_force(variant):
    fsmp, nsamples = 5, 30
    plan, args, available = _small_plan(fsmp=fsmp, nsamples=nsamples)
    tmax, targ, tsum = cb.detect_reduce_ablate_reference(*args, variant)
    shape = (plan.n_tiles, nsamples)
    assert tmax.shape == targ.shape == tsum.shape == shape
    assert (tmax.dtype, targ.dtype, tsum.dtype) == (
        torch.float32, torch.int32, torch.float32)

    ref_max, ref_sum, coas = _brute_force(plan, args[0], fsmp, nsamples,
                                          available, variant)
    # the sums of logs (noexp, noreduce, nogather) can be near 0: an
    # absolute floor of 1e-6 beside the relative tolerance
    np.testing.assert_allclose(tmax.numpy(), ref_max, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tsum.numpy(), ref_sum, rtol=RTOL, atol=1e-6)
    if variant in ("full", "noexp"):
        t = np.arange(nsamples)
        for i, coa in enumerate(coas):
            np.testing.assert_allclose(coa[targ[i].numpy(), t], ref_max[i],
                                       rtol=RTOL, atol=1e-6)
    else:
        assert (targ == 0).all()


def test_ablate_reference_full_is_the_plan_reference():
    plan, args, _ = _small_plan()
    full = cb.detect_reduce_ablate_reference(*args, "full")
    ref = cuda_migrate.detect_reduce_plan_reference(*args)
    for got, want in zip(full, ref):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown variant"):
        cb.detect_reduce_ablate_reference(*args, "k128")


def test_ablate_reference_chunks_agree():
    """Chunking the tiles (max_elements) changes nothing."""

    plan, args, _ = _small_plan(node_count=(9, 8, 6), tile=32)
    assert plan.n_tiles > 2
    for variant in cb.ABLATIONS:
        whole = cb.detect_reduce_ablate_reference(*args, variant)
        chunked = cb.detect_reduce_ablate_reference(
            *args, variant, max_elements=32 * 30)
        for got, want in zip(chunked, whole):
            assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 5])
def test_full_matches_pallas_mxu(seed):
    """FULL (the production contract) with the tile combine against the
    JAX MXU kernel in interpret mode. The MXU kernel's default int8
    3-word table encodes each log onset to within 7.7e-7
    (pallas_migrate.py:49-55), so its sums differ from the f32 gather by
    up to ~1e-6 relative: within RTOL here."""

    fsmp, nsamples, node_count = 16, 100, (10, 9, 8)
    work = _workload(seed)
    onsets, tt, mask, available = work
    mxu = PallasDetectMXU(tt, node_count, fsmp, nsamples, tile=64,
                          brick_shape=(4, 4, 4), interpret=True)
    ref = [np.asarray(x) for x in mxu(onsets, mask, available)]

    plan = cuda_migrate.DetectPlan(tt, node_count, tile=64,
                                   brick_shape=(4, 4, 4))
    logged = migrate._prepare_onsets(*_torch(onsets, mask))
    inv = torch.tensor([1.0 / available], dtype=torch.float32)
    parts = cb.detect_reduce_ablate_reference(
        logged, *_torch(plan.base, plan.fine, plan.valid), inv, fsmp,
        nsamples, "full")
    max_coa, max_idx, coa_sum = cuda_migrate.combine_tiles(
        *parts, torch.from_numpy(plan.perm), plan.tile)
    norm = max_coa * plan.n_nodes / coa_sum
    np.testing.assert_allclose(max_coa.numpy(), ref[0], rtol=RTOL)
    np.testing.assert_allclose(norm.numpy(), ref[1], rtol=RTOL)
    assert (max_idx.numpy() == ref[2]).mean() > 0.99
    _assert_tie_consistent(max_idx.numpy(), ref[0], work, fsmp)


@pytest.mark.parametrize("max_group", [1, 2, 4, 8, 6])
def test_resident_groups_brute_force(max_group):
    plan, args, _ = _small_plan(node_count=(9, 8, 6), tile=32)
    r_span = plan.r_span
    group, gbase, gwidth = cb.resident_groups(args[1], r_span, max_group)
    assert group == {6: 4}.get(max_group, max_group)
    n_groups = -(-plan.n_tiles // group)
    assert gbase.shape == (n_groups, plan.n_onsets)
    assert gbase.dtype == torch.int32
    spread = 0
    for g in range(n_groups):
        rows = plan.base[g * group:(g + 1) * group]
        np.testing.assert_array_equal(gbase[g].numpy(), rows.min(0))
        spread = max(spread, int((rows.max(0) - rows.min(0)).max()))
    assert gwidth == spread + r_span + cuda_migrate.SBLK
    # every tile's windows lie inside its group's union window
    for i in range(plan.n_tiles):
        off = plan.base[i] - gbase[i // group].numpy()
        assert (off >= 0).all()
        assert (off + r_span + cuda_migrate.SBLK <= gwidth).all()


def test_resident_groups_shrink_to_fit_and_raise():
    n_onsets = 24
    # bases spread far apart: pairs of tiles cannot share a window
    base = torch.tensor([[0] * n_onsets, [3000] * n_onsets] * 4,
                        dtype=torch.int32)
    group, _, gwidth = cb.resident_groups(base, 100, max_group=8)
    assert group == 1 and gwidth == 100 + cuda_migrate.SBLK
    assert cb.resident_smem(n_onsets, gwidth) <= cuda_migrate.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        cb.resident_groups(base, 3000, max_group=8)


def test_span_offsets():
    r_spans = (19, 19, 37, 37, 36)
    uniform = cb.span_offsets(r_spans, per_onset=False)
    per_onset = cb.span_offsets(r_spans, per_onset=True)
    width = 37 + cuda_migrate.SBLK
    np.testing.assert_array_equal(uniform, np.arange(6) * width)
    np.testing.assert_array_equal(
        np.diff(per_onset), np.array(r_spans) + cuda_migrate.SBLK)
    assert per_onset[0] == 0 and per_onset.dtype == np.int32
    assert cb.pipelined_smem(5, int(per_onset[-1]), 4) < cb.pipelined_smem(
        5, int(uniform[-1]), 4)


def test_breakdown_wrappers_refuse_cpu_tensors():
    """No wrapper runs a plain version in its kernel's place, and none
    counts a launch it did not make."""

    plan, args, _ = _small_plan()
    cb.reset_launches()
    offs = cb.span_offsets(plan.r_spans)
    group, gbase, gwidth = cb.resident_groups(args[1], plan.r_span)
    calls = [
        lambda: cb.migrate_detect_ablate_cuda(*args, plan.r_span, "full"),
        lambda: cb.migrate_detect_resident_cuda(*args, group, gbase, gwidth),
        lambda: cb.migrate_detect_pipelined_cuda(
            *args, torch.from_numpy(offs), int(offs[-1]), 3),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert set(cb.launches.values()) == {0}
    with pytest.raises(ValueError, match="unknown variant"):
        cb.migrate_detect_ablate_cuda(*args, plan.r_span, "k128")


def test_breakdown_entry_point_requires_cuda():
    """With no card visible the entry point exits non-zero, before any
    work."""

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m",
         "quakemigrate_torch.experiments.exp_kernel_breakdown", "--deep"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert exp_kernel_breakdown.NSAMPLES == 30_000


class _FakeEvent:
    """A CUDA event stand-in: ``query`` answers from a shared script."""

    script = []

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def query(self):
        return _FakeEvent.script.pop(0)

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 8.0


@pytest.mark.parametrize("drains, raises", [(0, False), (2, False),
                                             (4, True)])
def test_queued_ms_doubles_the_hold_while_the_queue_drains(
        monkeypatch, drains, raises):
    """queued_ms enqueues its calls behind a hold, doubles the hold while
    the start event completed before the last call was enqueued, and
    raises after HOLD_TRIES drained holds."""

    holds, calls = [], []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "_sleep", holds.append)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _FakeEvent.script = [True] * drains + [False]
    ekb = exp_kernel_breakdown
    if raises:
        with pytest.raises(RuntimeError, match="drained"):
            ekb.queued_ms(lambda: calls.append(1), reps=4, warmup=1)
        assert len(holds) == ekb.HOLD_TRIES
    else:
        assert ekb.queued_ms(lambda: calls.append(1), reps=4,
                             warmup=1) == 2.0
        assert len(calls) == 1 + 4 * (drains + 1)
    assert holds == [ekb.HOLD_CYCLES * 2 ** i for i in range(len(holds))]


@pytest.mark.parametrize("queued", [False, True])
def test_in_turns_order_and_clock(monkeypatch, queued):
    """in_turns times a, b, b, a with the clock asked for."""

    order = []
    ekb = exp_kernel_breakdown
    for name in ("cuda_ms", "queued_ms"):
        monkeypatch.setattr(
            ekb, name, lambda fn, reps, warmup, name=name:
            order.append((fn(), name)) or float(len(order)))
    ms = ekb.in_turns({"a": lambda: "a", "b": lambda: "b"}, 3, 1,
                      queued=queued)
    clock = "queued_ms" if queued else "cuda_ms"
    assert order == [(k, clock) for k in "abba"]
    assert ms == {"a": [1.0, 4.0], "b": [2.0, 3.0]}
