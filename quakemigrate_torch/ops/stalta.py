# -*- coding: utf-8 -*-
"""
STA/LTA onset (characteristic) functions on tensors, batched over the
leading dimensions. Semantics follow quakemigrate_tpu.ops.stalta:

- "overlapping" (classic): the STA window is the trailing ``nsta``
  samples of the LTA window, valued at their shared end sample. The
  first ``nlta-1`` samples are 1, and so is any sample whose LTA is below
  the dtype's smallest normal number.
- "centred": the STA window follows the LTA window, valued at the end of
  the LTA window. The first ``nlta-1`` and the last ``nsta`` samples are
  1, and so is any sample whose LTA is <= 0.

"""

import torch

from . import rolling


def overlapping_sta_lta(signal, nsta, nlta):
    """Classic STA/LTA with overlapping windows (static ``nsta``/``nlta``)."""

    n = signal.shape[-1]
    sta = rolling.trailing_window_sums(signal, nsta)
    lta = rolling.trailing_window_sums(signal, nlta)
    frac = nlta / nsta
    tiny = torch.finfo(signal.dtype).tiny
    ratio = torch.where(
        lta < tiny, 1.0, sta / torch.clamp(lta, min=tiny) * frac
    )
    valid = torch.arange(n, device=signal.device) >= (nlta - 1)
    return torch.where(valid, ratio, 1.0)


def centred_sta_lta(signal, nsta, nlta):
    """Centred STA/LTA: the STA window follows the LTA window."""

    n = signal.shape[-1]
    padded = rolling.padded_cumsum(signal)
    idx = torch.arange(n, device=signal.device)
    # lta[i] = sum(signal[i-nlta+1..i]); sta[i] = sum(signal[i+1..i+nsta])
    hi = padded[..., 1:]
    lta = hi - padded[..., torch.clamp(idx + 1 - nlta, min=0)]
    sta = padded[..., torch.clamp(idx + 1 + nsta, max=n)] - hi
    frac = nlta / nsta
    tiny = torch.finfo(signal.dtype).tiny
    ratio = torch.where(
        lta <= 0.0, 1.0, sta / torch.clamp(lta, min=tiny) * frac
    )
    valid = (idx >= (nlta - 1)) & (idx < n - nsta)
    return torch.where(valid, ratio, 1.0)


def signal_transform(data, transform="energy"):
    """
    Non-negative signal transform applied before the STA/LTA: "energy"
    (x**2), "abs", "env" (analytic-signal envelope) or "env_squared".

    """

    if transform == "energy":
        return data**2
    if transform == "abs":
        return torch.abs(data)
    if transform in ("env", "env_squared"):
        env = _envelope(data)
        return env**2 if transform == "env_squared" else env
    raise ValueError(f"Unknown signal transform: {transform}")


def _envelope(data):
    """|analytic signal| via an FFT Hilbert transform along the last axis."""

    n = data.shape[-1]
    spec = torch.fft.fft(data, dim=-1)
    h = torch.zeros(n, dtype=data.dtype, device=data.device)
    h[0] = 1
    if n % 2 == 0:
        h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[1 : (n + 1) // 2] = 2
    analytic = torch.fft.ifft(spec * h, dim=-1)
    return torch.abs(analytic)
