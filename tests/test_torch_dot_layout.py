# -*- coding: utf-8 -*-
"""
The one-hot product layouts of quakemigrate_torch (ops.dot_layout,
ops.cuda_dot_layout, experiments/exp_dot_layout.py) on the CPU: the plain
version of every mode against the JAX experiment kernel ``_kern``
(experiments/exp_dot_layout.py) run in a test-local ``pl.pallas_call``
in interpret mode, exactly (every product entry and, at these shapes,
every column sum is exact in float32); the closed form of the fill; the
TFLOP/s formula; the wrapper refusing a CPU device and shapes it does not
take; and the entry point exiting without CUDA. The CUDA kernel runs only
on the card (chip_smoke.py holds it against the plain version tested
here).

"""

import os
import pathlib
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from quakemigrate_torch.experiments import exp_dot_layout
from quakemigrate_torch.ops import cuda_dot_layout as cdl
from quakemigrate_torch.ops import dot_layout as dl

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from experiments import exp_dot_layout as j_exp  # noqa: E402

torch.set_num_threads(1)


def _jax_run(mode, K, M, N, steps):
    """The TPU experiment's ``run`` with ``interpret=True`` and the output
    returned whole (``run`` returns its sum)."""

    two = dl.MODES[mode]
    kern = partial(j_exp._kern, mode=mode, K=K, M=M, N=N, two=two)
    lhs_shape = (K, M) if mode in ("kk", "kk1", "kkT") else (M, K)
    rhs_shape = (K, N * (2 if two else 1))
    out = pl.pallas_call(
        kern,
        grid=(steps,),
        in_specs=[pl.BlockSpec((1,), lambda t: (0,),
                               memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((1, 1, N), lambda t: (t, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((steps, 1, N), jnp.float32),
        scratch_shapes=[
            pltpu.VMEM(lhs_shape, jnp.bfloat16),
            pltpu.VMEM(rhs_shape, jnp.bfloat16),
        ],
        interpret=True,
    )(jnp.zeros(1, jnp.int32))
    return np.asarray(out)


@pytest.mark.parametrize("mode", list(dl.MODES))
@pytest.mark.parametrize("K,M,N,steps", [(32, 16, 128, 2), (48, 24, 256, 1)])
def test_reference_equals_jax_kernel(mode, K, M, N, steps):
    want = _jax_run(mode, K, M, N, steps)
    got = dl.dot_layout_reference(mode, K, M, N, steps, "cpu")
    assert got.shape == (steps, 1, N) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(dl.checksum(got)) == float(want.sum())


@pytest.mark.parametrize("mode", list(dl.MODES))
def test_reference_closed_form(mode):
    """acc[m, n] = sum_k lhs * rhs of the iota fills, in float64."""

    K, M, N = 64, 40, 136
    got = dl.dot_layout_reference(mode, K, M, N, 3, "cpu").numpy()
    rhs_col = (np.arange(2 * N) % 5) * 0.25
    if mode in ("kk", "kk1", "kkT"):
        lhs_sum = K * (np.arange(M) % 7).sum() * 0.125  # sum over m, k
    else:
        lhs_sum = M * (np.arange(K) % 7).sum() * 0.125
    if dl.MODES[mode]:
        want = lhs_sum * (rhs_col[:N] + rhs_col[N:2 * N])
    else:
        want = lhs_sum * rhs_col[:N] * (1.0 if mode == "kkT" else 1.5)
    for t in range(3):
        np.testing.assert_array_equal(got[t, 0], want)


def test_fill_operands_layouts():
    lhs, rhs = dl.fill_operands("kk", 3, 9, 4, "cpu")
    assert lhs.shape == (3, 9) and rhs.shape == (3, 4)
    assert lhs.dtype == rhs.dtype == torch.bfloat16
    np.testing.assert_array_equal(lhs[1].float().numpy(),
                                  (np.arange(9) % 7) * 0.125)
    lhs, rhs = dl.fill_operands("mk1", 3, 9, 4, "cpu")
    assert lhs.shape == (9, 3) and rhs.shape == (3, 8)
    np.testing.assert_array_equal(rhs[2].float().numpy(),
                                  (np.arange(8) % 5) * 0.25)
    with pytest.raises(ValueError, match="unknown mode"):
        dl.fill_operands("km", 3, 9, 4, "cpu")


def test_tflops_formula():
    """The TPU experiment's count: 4 K M N a step, 2 K M N for kkT."""

    K, M, N = 1536, 1024, 2048
    for mode in ("kk", "kk1", "mk", "mk1"):
        assert dl.flops_per_step(mode, K, M, N) == 4 * K * M * N
    assert dl.flops_per_step("kkT", K, M, N) == 2 * K * M * N
    # 4096 steps at 53.4 ms is the bf16 dense peak of 989 TFLOP/s
    seconds = 4096 * 4 * K * M * N / 989e12
    assert dl.tflops("kk", K, M, N, 4096, seconds) == pytest.approx(989.0)
    assert dl.SHAPES == ((1536, 512, 2048), (1344, 512, 2048),
                         (1536, 1024, 2048))
    assert dl.STEPS == 4096


def test_wrapper_refuses_cpu_and_bad_shapes():
    cdl.reset_launches()
    with pytest.raises(ValueError, match="CUDA device"):
        cdl.dot_layout_cuda("kk", 64, 128, 128, 2, "cpu")
    for K, M, N, steps in ((48, 128, 128, 2), (64, 96, 128, 2),
                           (64, 128, 200, 2), (64, 128, 128, 0),
                           (64, 128, 128, 70000)):
        with pytest.raises(ValueError, match="dot_layout needs"):
            cdl.dot_layout_cuda("mk", K, M, N, steps, "cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        cdl.dot_layout_cuda("kt", 64, 128, 128, 2, "cpu")
    assert cdl.launches == {"dot_layout": 0, "dot_layout_v2": 0}
    # every shape of the TPU experiment fits the kernel's tiles
    for K, M, N in dl.SHAPES:
        cdl.check_shape(K, M, N, dl.STEPS)


def test_entry_point_requires_cuda():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m",
         "quakemigrate_torch.experiments.exp_dot_layout"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert exp_dot_layout.RTOL == 1e-6
