# -*- coding: utf-8 -*-
"""
The wrapper of R1, ``csrc/recursive_stalta.cu``: the recursive STA/LTA of
:func:`quakemigrate_torch.ops.stalta.recursive_sta_lta` on the card, one
block a row walking the row in chunks with the state carried across them
(the design is in the source). Its plain version is
:func:`quakemigrate_torch.ops.stalta.recursive_sta_lta_plain`.

Counterpart of the XLA associative scan of the JAX package's
``ops/stalta.py::recursive_sta_lta``; no Pallas kernel computes it.

"""

import torch

from .cuda_migrate import launch_kernel

# Launches of R1, counted by its wrapper where it launches
launches = {"recursive_stalta": 0}

_ENTRIES = {torch.float32: "qm_recursive_stalta_f32",
            torch.float64: "qm_recursive_stalta_f64"}


def reset_launches():
    for name in launches:
        launches[name] = 0


def recursive_sta_lta_cuda(signal, nsta, nlta):
    """
    R1 on a CUDA tensor ``signal`` [..., n], float32 or float64: the onset
    in the input's dtype and shape. Raises on a CPU tensor, another dtype,
    ``nsta`` or ``nlta`` below 1, or a failed launch.

    """

    if not signal.is_cuda:
        raise ValueError("recursive_sta_lta_cuda takes a CUDA tensor")
    entry = _ENTRIES.get(signal.dtype)
    if entry is None:
        raise TypeError(f"R1 takes float32 or float64, not {signal.dtype}")
    nsta, nlta = int(nsta), int(nlta)
    if nsta < 1 or nlta < 1:
        raise ValueError(f"nsta ({nsta}) and nlta ({nlta}) must be >= 1")
    n = signal.shape[-1]
    rows = signal.numel() // n if n else 0
    if rows >= 2**31 or n >= 2**31:
        raise ValueError(f"R1 takes fewer than 2**31 rows and samples, not "
                         f"{rows} x {n}")
    x = signal.contiguous()
    out = torch.empty_like(x)
    launch_kernel(entry, x.device, x.data_ptr(), out.data_ptr(), rows, n,
                  nsta, nlta)
    launches["recursive_stalta"] += 1
    return out
