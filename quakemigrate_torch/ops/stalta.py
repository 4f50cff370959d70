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
- "recursive": exponential-decay recursions for STA and LTA; the onset is
  0 at sample 0, and the first ``nlta`` samples are 1 when ``nlta < n``.
  On a CUDA tensor it runs R1 (``ops.cuda_stalta``), on a CPU tensor its
  plain version, an affine-pair scan.

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


def recursive_sta_lta(signal, nsta, nlta):
    """
    Recursive STA/LTA, ``sta_i = c*x_i + (1-c)*sta_{i-1}`` with ``c =
    1/nsta`` (likewise lta), batched over the leading dimensions, in the
    input's dtype. As the reference (onsetlib.c:126-148 and its
    zero-initialised output): the recursion starts at sample 1 (sample 0
    is taken as 0, its decay as 0); ``onset = sta / max(lta, tiny)``,
    ``onset[0] = 0``; when ``nlta < n`` the first ``nlta`` samples, sample
    0 included, are 1. A CUDA tensor goes to R1
    (:func:`~quakemigrate_torch.ops.cuda_stalta.recursive_sta_lta_cuda`,
    which raises where it cannot run), a CPU tensor to
    :func:`recursive_sta_lta_plain`.

    """

    if signal.is_cuda:
        from .cuda_stalta import recursive_sta_lta_cuda

        return recursive_sta_lta_cuda(signal, nsta, nlta)
    return recursive_sta_lta_plain(signal, nsta, nlta)


def _ewma(signal, c):
    """
    ``s_i = c*x_i + (1-c)*s_{i-1}`` along the last axis, ``s_{-1} = 0``,
    sample 0 taken as 0 with decay 0: an inclusive scan of the affine maps
    ``s -> m_i*s + v_i`` by log2(n) doubling steps, each composing every
    sample's map with the one ``d`` samples before it, ``(m, v) then (m',
    v') = (m*m', v*m' + v')``. The decays ``m`` are the same in every row,
    so they are scanned once, [n]. No cumulative product of the decays is
    formed (it underflows long before the row ends).

    """

    n = signal.shape[-1]
    v = c * signal
    v[..., 0] = 0.0
    m = torch.full((n,), 1.0 - c, dtype=signal.dtype, device=signal.device)
    m[0] = 0.0
    d = 1
    while d < n:
        v = torch.cat([v[..., :d], v[..., :-d] * m[d:] + v[..., d:]], dim=-1)
        m = torch.cat([m[:d], m[:-d] * m[d:]])
        d *= 2
    return v


def recursive_sta_lta_plain(signal, nsta, nlta):
    """The plain version of :func:`recursive_sta_lta` (and of R1): two
    affine-pair scans (:func:`_ewma`) and the onset's edges, in the
    input's dtype, on any device."""

    n = signal.shape[-1]
    sta = _ewma(signal, 1.0 / nsta)
    lta = _ewma(signal, 1.0 / nlta)
    tiny = torch.finfo(signal.dtype).tiny
    onset = sta / torch.clamp(lta, min=tiny)
    onset[..., 0] = 0.0
    if nlta < n:
        onset[..., :nlta] = 1.0
    return onset


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
