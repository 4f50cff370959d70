# -*- coding: utf-8 -*-
"""
The one-hot product layouts on the tensor cores (``csrc/dot_layout.cu``):
the wrapper and its launch count, and the library yardstick.

Counterpart of the TPU experiment kernel ``_kern``
(``experiments/exp_dot_layout.py``); its plain version is
:func:`~quakemigrate_torch.ops.dot_layout.dot_layout_reference`.

"""

import torch

from .cuda_migrate import launch_kernel
from .dot_layout import MODES, check_mode, fill_operands

# Tiles of the kernel (csrc/dot_layout.cu: QD_BK, QD_BM, QD_BN)
BK, BM, BN = 32, 128, 128
MAX_STEPS = 65535  # one grid row per step

# Launches of the kernel, counted by its wrapper where it launches.
launches = {"dot_layout": 0}


def reset_launches():
    launches["dot_layout"] = 0


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


def dot_layout_cuda(mode, K, M, N, steps, device):
    """
    Fill the operands of ``mode`` on ``device`` (a CUDA device) with the
    kernel's fill and run ``steps`` steps of the product. Returns ``out``
    float32 ``[steps, 1, N]``, asynchronously on the current stream.

    """

    check_mode(mode)
    check_shape(K, M, N, steps)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA device, got {device}")
    mode_i = tuple(MODES).index(mode)
    lhs = torch.empty(K * M, dtype=torch.bfloat16, device=device)
    rhs = torch.empty(K * N * (2 if MODES[mode] else 1), dtype=torch.bfloat16,
                      device=device)
    out = torch.empty((steps, 1, N), dtype=torch.float32, device=device)
    launch_kernel("qm_dot_layout_fill", device, lhs.data_ptr(),
                  rhs.data_ptr(), mode_i, K, M, N)
    launch_kernel("qm_dot_layout", device, lhs.data_ptr(), rhs.data_ptr(),
                  out.data_ptr(), mode_i, K, M, N, steps)
    launches["dot_layout"] += 1
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
