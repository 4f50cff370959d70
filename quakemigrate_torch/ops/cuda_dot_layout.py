# -*- coding: utf-8 -*-
"""
The one-hot product layouts on the tensor cores: the wrappers of v1
(``csrc/dot_layout.cu``, ``mma.sync``) and v2 (``csrc/dot_layout_v2.cu``,
``wgmma`` fed by a TMA ring), their launch counts and the bytes each
stages from L2 a step, and the library yardstick.

Counterpart of the TPU experiment kernel ``_kern``
(``experiments/exp_dot_layout.py``); its plain version is
:func:`~quakemigrate_torch.ops.dot_layout.dot_layout_reference`.

"""

import torch

from .cuda_migrate import launch_kernel
from .dot_layout import MODES, check_mode, fill_operands

# Tiles of v1 (csrc/dot_layout.cu: QD_BK, QD_BM, QD_BN)
BK, BM, BN = 32, 128, 128
# Tiles of v2 (csrc/dot_layout_v2.cu: QV_BK, QV_BM, QV_BN)
V2_BK, V2_BM, V2_BN = 64, 128, 256
MAX_STEPS = 65535  # one grid row per step

# Launches of the kernels, counted by their wrappers where they launch.
launches = {"dot_layout": 0, "dot_layout_v2": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


def check_shape(K, M, N, steps):
    """Raise on a shape the kernel does not take: K a multiple of 32, M
    and N of 128, 1 <= steps <= 65535."""

    if (K < BK or K % BK or M < BM or M % BM or N < BN or N % BN
            or not 1 <= steps <= MAX_STEPS):
        raise ValueError(
            f"dot_layout needs K a multiple of {BK}, M of {BM}, N of {BN} "
            f"and 1..{MAX_STEPS} steps; got K {K}, M {M}, N {N}, steps "
            f"{steps}"
        )


def check_shape_v2(K, M, N, steps):
    """Raise on a shape v2 does not take: K a multiple of 64, M of 128,
    N of 256, 1 <= steps <= 65535."""

    if (K < V2_BK or K % V2_BK or M < V2_BM or M % V2_BM or N < V2_BN
            or N % V2_BN or not 1 <= steps <= MAX_STEPS):
        raise ValueError(
            f"dot_layout_v2 needs K a multiple of {V2_BK}, M of {V2_BM}, N "
            f"of {V2_BN} and 1..{MAX_STEPS} steps; got K {K}, M {M}, N {N}, "
            f"steps {steps}"
        )


def b_operands(mode):
    """B operands of one step: two (rhs and rhs * 0.5, or the two column
    halves of rhs), one for ``kkT``."""

    check_mode(mode)
    return 1 if mode == "kkT" else 2


def staged_bytes_v1(mode, K, M, N):
    """Bytes v1 stages from L2 into shared memory a step: each of its N /
    128 blocks stages an 8 KB A tile and an 8 KB B tile per (32 k, 128
    rows of M), for each column half in ``kk1``/``mk1``."""

    check_mode(mode)
    halves = 2 if MODES[mode] else 1
    return (N // BN) * halves * (M // BM) * (K // BK) * (
        BM * BK * 2 + BK * BN * 2)


def staged_bytes_v2(mode, K, M, N):
    """Bytes v2 stages from L2 into shared memory a step: each of its N /
    256 blocks stages all of A once and its 256-column strip of each B
    operand once."""

    return (N // V2_BN) * (2 * K * M + b_operands(mode) * K * V2_BN * 2)


def _filled_operands(mode, K, M, N, steps, device, check):
    """Check the arguments with ``check`` (a shape check), then fill lhs
    and rhs of ``mode`` on ``device`` (a CUDA device) with the kernel
    library's fill. Returns (device, mode index, lhs, rhs)."""

    check_mode(mode)
    check(K, M, N, steps)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA device, got {device}")
    mode_i = tuple(MODES).index(mode)
    lhs = torch.empty(K * M, dtype=torch.bfloat16, device=device)
    rhs = torch.empty(K * N * (2 if MODES[mode] else 1), dtype=torch.bfloat16,
                      device=device)
    launch_kernel("qm_dot_layout_fill", device, lhs.data_ptr(),
                  rhs.data_ptr(), mode_i, K, M, N)
    return device, mode_i, lhs, rhs


def dot_layout_cuda(mode, K, M, N, steps, device):
    """
    Fill the operands of ``mode`` on ``device`` (a CUDA device) with the
    kernel's fill and run ``steps`` steps of the product. Returns ``out``
    float32 ``[steps, 1, N]``, asynchronously on the current stream.

    """

    device, mode_i, lhs, rhs = _filled_operands(mode, K, M, N, steps, device,
                                                check_shape)
    out = torch.empty((steps, 1, N), dtype=torch.float32, device=device)
    launch_kernel("qm_dot_layout", device, lhs.data_ptr(), rhs.data_ptr(),
                  out.data_ptr(), mode_i, K, M, N, steps)
    launches["dot_layout"] += 1
    return out


def dot_layout_v2_cuda(mode, K, M, N, steps, device):
    """
    v2 (``csrc/dot_layout_v2.cu``): fill the operands of ``mode`` on
    ``device`` (a CUDA device) as v1 does, make ``rhs * 0.5`` in ``kk``
    and ``mk``, and run ``steps`` steps. Returns ``out`` float32
    ``[steps, 1, N]``, asynchronously on the current stream.

    """

    device, mode_i, lhs, rhs = _filled_operands(mode, K, M, N, steps, device,
                                                check_shape_v2)
    half = mode in ("kk", "mk")
    rhs_half = torch.empty(K * N if half else 1, dtype=torch.bfloat16,
                           device=device)
    out = torch.empty((steps, 1, N), dtype=torch.float32, device=device)
    launch_kernel("qm_dot_layout_v2", device, lhs.data_ptr(), rhs.data_ptr(),
                  rhs_half.data_ptr(), out.data_ptr(), mode_i, K, M, N,
                  steps)
    launches["dot_layout_v2"] += 1
    return out


def library_step(mode, K, M, N, device):
    """
    The library yardstick of one step: ``torch.matmul`` (cuBLAS, bf16
    output) on the same bf16 operands for the same products a step makes
    (two, or one of width 2N, or one for ``kkT``). Returns a function of
    no arguments that runs one step; the port never calls it.

    """

    lhs, rhs = fill_operands(mode, K, M, N, device)
    a = lhs.t() if mode in ("kk", "kk1", "kkT") else lhs
    if MODES[mode] or mode == "kkT":
        return lambda: torch.matmul(a, rhs)
    rhs_half = rhs * 0.5
    return lambda: (torch.matmul(a, rhs), torch.matmul(a, rhs_half))
