# -*- coding: utf-8 -*-
"""
The one trailing-window rolling-sum primitive shared by the onset
functions (STA/LTA windows and the fused detect window).

Early samples are partial-window sums: the window start is clamped with
``max(i+1-n, 0)``, matching quakemigrate_tpu.ops.rolling.

The windowed sums are differences of a running sum, so in float32 their
rounding follows the order of the running sum's additions. On CPU tensors
the running sum takes the order the JAX reference's ``jnp.cumsum`` takes
on the CPU (XLA rewrites it as a blocked scan: sequential additions
within blocks of 16, then the same over the block totals), so the plain
detect path agrees with the reference to float32 rounding of the later
steps (about 1e-7 relative) instead of the running sum's own error
(about 1e-5 at 2,000 samples). On CUDA tensors it is ``torch.cumsum``,
one launch, unless the caller asks for the reference's order: the plain
front ends of the fused detect window do (the contract of FE1 and FE2,
``csrc/front_end.cu``, which add in :func:`blocked_cumsum`'s order), and
so do the kurtosis moments, since after an event their windowed
differences cancel and two orders then differ by ~4e-3 relative
(``PERF.md`` §6), so only the same order gives the card the CPU's
values. That order costs about 40 launches of one elementwise addition
each.

"""

import numpy as np
import torch


# Block length of the reference's blocked scan (XLA's CPU rewrite of a
# cumulative reduce-window)
SCAN_BLOCK = 16


def _sequential_cumsum(x):
    """Running sum along the last axis, one addition at a time in the
    tensor's dtype (torch.cumsum on the CPU accumulates float32 in
    float64)."""

    out = x.clone()
    columns = out.unbind(-1)
    for k in range(1, len(columns)):
        columns[k].add_(columns[k - 1])
    return out


def blocked_cumsum(x, block=SCAN_BLOCK):
    """Running sum along the last axis in the reference's order: within
    each block of ``block`` samples sequentially, plus the exclusive
    running sum (taken the same way) of the block totals."""

    n = x.shape[-1]
    if n <= block:
        return _sequential_cumsum(x)
    n_blocks = -(-n // block)
    tiles = torch.nn.functional.pad(x, (0, n_blocks * block - n)).reshape(
        x.shape[:-1] + (n_blocks, block))
    inner = _sequential_cumsum(tiles)
    outer = blocked_cumsum(inner[..., -1], block)
    before = torch.nn.functional.pad(outer[..., :-1], (1, 0))
    return (inner + before[..., None]).reshape(
        x.shape[:-1] + (n_blocks * block,))[..., :n]


def padded_cumsum(x, reference_order=False):
    """Cumulative sum along the last axis with a leading zero, so that
    ``out[..., j] - out[..., i]`` is ``sum(x[..., i:j])``. In the
    reference's order (:func:`blocked_cumsum`) on CPU tensors, or on any
    with ``reference_order``; else ``torch.cumsum``."""

    blocked = reference_order or x.device.type == "cpu"
    c = blocked_cumsum(x) if blocked else torch.cumsum(x, -1)
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=c.dtype, device=c.device)
    return torch.cat([zero, c], dim=-1)


def trailing_window_sums(x, n, reference_order=False):
    """
    Trailing-window rolling sums: ``out[..., i] = sum(x[..., lo : i+1])``
    with ``lo = max(0, i + 1 - n)`` (partial windows at the start).

    ``n`` is either a Python int (any batch shape for ``x``) or a 1-D
    integer tensor of per-row window lengths (then ``x`` is 2-D,
    ``(rows, t)``). ``reference_order``: see :func:`padded_cumsum`.

    """

    t = x.shape[-1]
    idx = torch.arange(t, device=x.device)
    padded = padded_cumsum(x, reference_order)
    hi = padded[..., 1:]
    if isinstance(n, (int, np.integer)):
        return hi - padded[..., torch.clamp(idx + 1 - int(n), min=0)]
    n = torch.as_tensor(n, device=x.device)
    lo_idx = torch.clamp(idx[None, :] + 1 - n[:, None], min=0)
    return hi - torch.gather(padded, -1, lo_idx)
