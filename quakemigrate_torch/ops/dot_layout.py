# -*- coding: utf-8 -*-
"""
The one-hot product layouts of the TPU experiment
``experiments/exp_dot_layout.py`` in plain PyTorch: the plain version of
the tensor-core kernel ``csrc/dot_layout.cu`` (wrapper
:mod:`quakemigrate_torch.ops.cuda_dot_layout`).

Per step of ``steps``, on persistent bf16 operands filled once
(``lhs = (iota % 7) * 0.125`` and ``rhs = (iota % 5) * 0.25`` along dim 1):

- ``kk``: lhs ``[K, M]`` contracted on dim 0 with rhs ``[K, N]``, plus the
  same product with ``rhs * 0.5``;
- ``mk``: lhs ``[M, K]`` contracted on dim 1, the same two products;
- ``kk1``, ``mk1``: one product with rhs ``[K, 2N]``, both column halves
  summed;
- ``kkT``: lhs ``[K, M]`` transposed, then one ``mk`` product;

and ``out[t, 0, :]`` is the sum of the product over its M rows. Every
product entry is exact in float32 (sums of K products of dyadic values
with few bits); only the sum over M may round.

"""

import torch

# mode -> whether its one product is twice as wide (the TPU ``two``)
MODES = {"kk": False, "kk1": True, "mk": False, "mk1": True, "kkT": False}
# (K, M, N) of the TPU experiment's ``main``, at 4096 steps
SHAPES = ((1536, 512, 2048), (1344, 512, 2048), (1536, 1024, 2048))
STEPS = 4096


def check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {tuple(MODES)}")


def fill_operands(mode, K, M, N, device):
    """The persistent operands of ``mode`` as the TPU kernel's first step
    fills them: (lhs bf16 ``[K, M]`` or ``[M, K]``, rhs bf16 ``[K, N]`` or
    ``[K, 2N]``)."""

    check_mode(mode)
    lhs_shape = (K, M) if mode in ("kk", "kk1", "kkT") else (M, K)
    nb = N * (2 if MODES[mode] else 1)

    def iota(rows, cols, mod, scale):
        col = torch.arange(cols, device=device) % mod
        return (col.to(torch.bfloat16) * scale).expand(rows, cols).contiguous()

    return iota(*lhs_shape, 7, 0.125), iota(K, nb, 5, 0.25)


def step_product(mode, lhs, rhs, N):
    """One step's column sums, ``[N]`` float32, from the operands."""

    a = lhs.float()
    a = a.T if mode in ("kk", "kk1", "kkT") else a  # [M, K]
    b = rhs.float()
    acc = a @ b
    if MODES[mode]:
        return (acc[:, :N] + acc[:, N:2 * N]).sum(0)
    if mode != "kkT":
        acc = acc + a @ (b * 0.5)
    return acc.sum(0)


def dot_layout_reference(mode, K, M, N, steps, device):
    """
    Plain version of the kernel: ``out`` float32 ``[steps, 1, N]``. Every
    step computes the same function of the persistent operands, so the
    product is computed once and repeated over the steps.

    """

    lhs, rhs = fill_operands(mode, K, M, N, device)
    col = step_product(mode, lhs, rhs, N)
    return col.reshape(1, 1, N).expand(steps, 1, N).contiguous()


def checksum(out):
    """``out.sum()``, the value the TPU experiment's ``run`` returns."""

    return out.sum()


def flops_per_step(mode, K, M, N):
    """The TPU experiment's count: 4 K M N a step (two products, or one of
    width 2N), 2 K M N for ``kkT``."""

    check_mode(mode)
    return 2 * K * M * N if mode == "kkT" else 4 * K * M * N


def tflops(mode, K, M, N, steps, seconds):
    """TFLOP/s of ``steps`` steps in ``seconds``, as the TPU experiment
    prints them."""

    return flops_per_step(mode, K, M, N) * steps / seconds / 1e12
