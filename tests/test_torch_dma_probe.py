# -*- coding: utf-8 -*-
"""
The staging and streaming probes of quakemigrate_torch (ops.cuda_probe,
experiments/exp_dma_probe.py) on the CPU: the stream's chunk index against
the TPU kernel's formula, its plain version against numpy, its piece
geometry at the TPU sizes; the ``packed`` closed form against the plan
reference on all-zero onsets and ``static2``'s plain version against the
plan reference, exactly; the slot layout the packed copy needs; the
wrappers refusing CPU tensors; and both entry points exiting without
CUDA.

The JAX kernels (``_stream_kernel``, ``_probe_kernel`` of
experiments/exp_dma_probe.py) cannot run on the CPU: they take no
``interpret`` argument and stage with TPU DMAs. The CUDA kernels run only
on the card (chip_smoke.py holds each against the plain versions tested
here).

"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops import cuda_migrate
from quakemigrate_torch.ops import cuda_probe as cp

from test_torch_breakdown import _small_plan

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n_chunks", [1, 3, 7, 2048])
def test_stream_chunk_matches_tpu_formula(n_chunks):
    """``step - (step // n) * n`` as the TPU kernel computes it in int32
    (exp_dma_probe.py:55-58), mirrored in numpy."""

    steps = np.arange(0, 5 * n_chunks + 3, dtype=np.int32)
    tpu = jax.jit(lambda t: t - jax.lax.div(t, jnp.int32(n_chunks))
                  * jnp.int32(n_chunks))(jnp.asarray(steps))
    mirror = steps - (steps // n_chunks) * n_chunks
    np.testing.assert_array_equal(np.asarray(tpu), mirror)
    np.testing.assert_array_equal(cp.stream_chunk(steps, n_chunks), mirror)
    assert cp.stream_chunk(int(steps[-1]), n_chunks) == mirror[-1]


@pytest.mark.parametrize("rows,n_total", [(8, 13), (16, 4), (24, 1)])
def test_stream_reference_against_numpy(rows, n_total):
    n_chunks = 3
    rng = np.random.default_rng(rows)
    values = rng.normal(size=(n_chunks, rows, cp.ROW_SAMPLES))
    src = torch.from_numpy(values.astype(np.float32)).to(torch.bfloat16)
    out = cp.stream_probe_reference(src, n_total)
    assert out.shape == (8, 128) and out.dtype == torch.float32
    chunk = (n_total - 1) - ((n_total - 1) // n_chunks) * n_chunks
    want = src.float().numpy()[chunk, :8, :128]
    np.testing.assert_array_equal(out.numpy(), want)


def test_stream_source_seeded():
    g = cp.stream_geometry(8, source_bytes=3 * 8 * cp.ROW_BYTES,
                           stream_bytes=10 * 8 * cp.ROW_BYTES)
    assert (g.n_chunks, g.n_total) == (3, 10)
    a = cp.stream_source(g, "cpu", seed=3)
    b = cp.stream_source(g, "cpu", seed=3)
    assert a.shape == (3, 8, cp.ROW_SAMPLES) and a.dtype == torch.bfloat16
    assert torch.equal(a, b) and a.float().std() > 0.5


@pytest.mark.parametrize("rows", cp.STREAM_ROWS)
def test_stream_geometry_at_tpu_sizes(rows):
    """The TPU probe's sizes (exp_dma_probe.py:94-99) and the kernel's
    pieces: 8 rows of 2048 bf16, two slots of shared memory."""

    g = cp.stream_geometry(rows)
    chunk_bytes = rows * 2048 * 2
    assert g.chunk_bytes == chunk_bytes
    assert g.n_chunks == 2**29 // chunk_bytes
    assert g.n_total == 16 * 2**30 // chunk_bytes
    assert g.stream_bytes == 16 * 2**30
    assert g.pieces_per_chunk == rows // 8
    assert g.n_pieces == g.n_total * rows // 8 == 16 * 2**30 // 32768
    assert g.piece_bytes * g.pieces_per_chunk == chunk_bytes
    assert g.smem == 65536 <= cuda_migrate.SMEM_LIMIT
    small = cp.stream_geometry(rows, stream_bytes=2 * 2**30)
    assert small.n_total * 8 == g.n_total
    assert small.n_total % small.n_chunks == 0


def test_stream_geometry_refuses_bad_rows():
    for rows in (4, 12):
        with pytest.raises(ValueError, match="multiple of 8"):
            cp.stream_geometry(rows)
    with pytest.raises(ValueError, match="does not fit"):
        cp.stream_geometry(1024, source_bytes=2**20)


@pytest.mark.parametrize("seed,node_count,tile", [
    (1, (6, 5, 4), 32), (2, (9, 8, 6), 32), (3, (9, 8, 6), 64),
])
def test_packed_closed_form_equals_plan_reference_on_zero_onsets(
        seed, node_count, tile):
    plan, args, _ = _small_plan(seed=seed, node_count=node_count, tile=tile)
    assert (plan.valid == 0).any()  # padding nodes in some tile
    zero_args = (torch.zeros_like(args[0]),) + args[1:]
    want = cuda_migrate.detect_reduce_plan_reference(*zero_args)
    closed = cp.packed_reference(args[3], args[-1])
    probe = cp.detect_reduce_probe_reference(*args, "packed")
    for c, p, w in zip(closed, probe, want):
        assert c.dtype == w.dtype and c.shape == w.shape
        assert torch.equal(c, w) and torch.equal(p, w)


def test_static2_reference_is_the_plan_reference():
    plan, args, _ = _small_plan(node_count=(9, 8, 6), tile=32)
    want = cuda_migrate.detect_reduce_plan_reference(*args)
    got = cp.detect_reduce_probe_reference(*args, "static2")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unknown mode"):
        cp.detect_reduce_probe_reference(*args, "stream")


def test_packed_slot_layout():
    """The packed copy moves 16-byte runs: aligned spans give a slot and
    a zero table sized in whole runs."""

    r_spans = (19, 43, 42, 21)
    offs = cb.span_offsets(r_spans, per_onset=False, align=4)
    np.testing.assert_array_equal(offs, np.arange(5) * 172)
    per_onset = cb.span_offsets(r_spans, per_onset=True, align=4)
    np.testing.assert_array_equal(np.diff(per_onset), [148, 172, 172, 152])
    np.testing.assert_array_equal(cb.span_offsets(r_spans),
                                  cb.span_offsets(r_spans, align=1))
    zeros = cp.packed_zeros(300, int(offs[-1]), "cpu")
    assert zeros.numel() == 3 * 688 and not zeros.any()


def test_probe_wrappers_refuse_cpu_tensors():
    """No wrapper runs a plain version in its kernel's place, and none
    counts a launch it did not make."""

    plan, args, _ = _small_plan()
    cp.reset_launches()
    offs = cb.span_offsets(plan.r_spans, per_onset=False, align=4)
    span_off = torch.from_numpy(offs)
    zeros = cp.packed_zeros(args[-1], int(offs[-1]), "cpu")
    for mode in cp.PROBE_MODES:
        with pytest.raises(ValueError, match="CUDA tensors"):
            cp.migrate_detect_probe_cuda(*args, span_off, int(offs[-1]), mode,
                                         zeros)
    with pytest.raises(ValueError, match="unknown mode"):
        cp.migrate_detect_probe_cuda(*args, span_off, int(offs[-1]), "deep")
    src = torch.zeros((2, 8, cp.ROW_SAMPLES), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cp.stream_probe_cuda(src, 4)
    assert set(cp.launches.values()) == {0}


@pytest.mark.parametrize("args", [[], ["--stream"]])
def test_probe_entry_points_require_cuda(args):
    """With no card visible both entry points exit non-zero, before any
    work."""

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "quakemigrate_torch.experiments.exp_dma_probe",
         *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
