# -*- coding: utf-8 -*-
"""
The one trailing-window rolling-sum primitive shared by the onset
functions (STA/LTA windows and the fused detect window).

Early samples are partial-window sums: the window start is clamped with
``max(i+1-n, 0)``, matching quakemigrate_tpu.ops.rolling.

"""

import numpy as np
import torch


def padded_cumsum(x):
    """Cumulative sum along the last axis with a leading zero, so that
    ``out[..., j] - out[..., i]`` is ``sum(x[..., i:j])``."""

    c = torch.cumsum(x, dim=-1)
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=c.dtype, device=c.device)
    return torch.cat([zero, c], dim=-1)


def trailing_window_sums(x, n):
    """
    Trailing-window rolling sums: ``out[..., i] = sum(x[..., lo : i+1])``
    with ``lo = max(0, i + 1 - n)`` (partial windows at the start).

    ``n`` is either a Python int (any batch shape for ``x``) or a 1-D
    integer tensor of per-row window lengths (then ``x`` is 2-D,
    ``(rows, t)``).

    """

    t = x.shape[-1]
    idx = torch.arange(t, device=x.device)
    padded = padded_cumsum(x)
    hi = padded[..., 1:]
    if isinstance(n, (int, np.integer)):
        return hi - padded[..., torch.clamp(idx + 1 - int(n), min=0)]
    n = torch.as_tensor(n, device=x.device)
    lo_idx = torch.clamp(idx[None, :] + 1 - n[:, None], min=0)
    return hi - torch.gather(padded, -1, lo_idx)
