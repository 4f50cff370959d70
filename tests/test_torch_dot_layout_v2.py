# -*- coding: utf-8 -*-
"""
E5 v2, the one-hot product layouts on ``wgmma`` fed by a TMA ring
(``csrc/dot_layout_v2.cu``, wrapper ``ops.cuda_dot_layout``), on the CPU:
its wrapper refusing a CPU device, shapes its tiles do not take and
unknown modes without counting a launch; every shape of the TPU
experiment passing its shape check; the bytes v1 and v2 stage from L2 a
step against their closed forms; its plain version (the one v1 shares)
against the JAX experiment kernel at v2's small case; and chip_smoke.py
exiting without CUDA, in the repository and alone. The kernel runs only
on the card, where chip_smoke.py holds it bit for bit to the plain
version at its small case and within 1e-6 at the TPU shapes.

"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from quakemigrate_torch.ops import cuda_dot_layout as cdl
from quakemigrate_torch.ops import dot_layout as dl

from test_torch_dot_layout import _jax_run

REPO = pathlib.Path(__file__).resolve().parents[1]
HEAD = (1536, 1024, 2048)  # the TPU experiment's largest shape

torch.set_num_threads(1)


def test_wrapper_refuses_cpu_bad_shapes_and_modes():
    cdl.reset_launches()
    with pytest.raises(ValueError, match="CUDA device"):
        cdl.dot_layout_v2_cuda("kk", 128, 256, 512, 3, "cpu")
    # v1's tiles (K 32, N 128) are too fine for v2 (K 64, N 256)
    for K, M, N, steps in ((96, 256, 512, 3), (128, 192, 512, 3),
                           (128, 256, 384, 3), (64, 256, 384, 3),
                           (128, 256, 512, 0), (128, 256, 512, 70000)):
        with pytest.raises(ValueError, match="dot_layout_v2 needs"):
            cdl.dot_layout_v2_cuda("mk1", K, M, N, steps, "cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        cdl.dot_layout_v2_cuda("km", 128, 256, 512, 3, "cpu")
    assert cdl.launches == {"dot_layout": 0, "dot_layout_v2": 0}


@pytest.mark.parametrize("K,M,N", dl.SHAPES)
def test_every_tpu_shape_fits_v2(K, M, N):
    cdl.check_shape_v2(K, M, N, dl.STEPS)


@pytest.mark.parametrize("mode", list(dl.MODES))
def test_staged_bytes_closed_form(mode):
    """v1: N / 128 blocks, each stages 16 KB per (32 k, 128 rows) and
    column half, 64 K M bytes a step at N = 2048 (100.7 MB at the head
    shape for kk). v2: N / 256 blocks, each stages A once and a 256-column
    strip of each B operand once."""

    K, M, N = HEAD
    halves = 2 if dl.MODES[mode] else 1
    assert cdl.staged_bytes_v1(mode, K, M, N) == halves * N * K * M // 32
    assert cdl.staged_bytes_v1("kk", K, M, N) == 100_663_296
    ops = 1 if mode == "kkT" else 2
    assert cdl.b_operands(mode) == ops
    v2 = cdl.staged_bytes_v2(mode, K, M, N)
    assert v2 == N * K * M // 128 + 2 * ops * N * K
    assert v2 == {1: 31_457_280, 2: 37_748_736}[ops]
    # v2 stages 2.7x (kk, mk, kkT) to 5.3x (kk1, mk1) fewer bytes
    assert cdl.staged_bytes_v1(mode, K, M, N) / v2 > 2.6


@pytest.mark.parametrize("mode", list(dl.MODES))
def test_reference_at_v2_small_case_equals_jax_kernel(mode):
    """The plain version at v2's small case in chip_smoke.py, (128, 256,
    512, 3), against the JAX kernel in interpret mode, exactly."""

    K, M, N, steps = 128, 256, 512, 3
    cdl.check_shape_v2(K, M, N, steps)
    got = dl.dot_layout_reference(mode, K, M, N, steps, "cpu")
    np.testing.assert_array_equal(got.numpy(), _jax_run(mode, K, M, N, steps))


def test_chip_smoke_fails_alone_and_without_cuda(tmp_path):
    """chip_smoke.py prints no result without CUDA, and in a directory
    that holds nothing else of the repository."""

    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", script)
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        env.pop("PYTHONPATH", None)
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
