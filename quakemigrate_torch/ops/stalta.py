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

The classic and centred forms run ON1 v2 (``ops.cuda_onsets``) on a CUDA
tensor, their plain versions (the ``_plain`` functions) on a CPU tensor;
:func:`station_sta_lta` adds the transform and locate's per-station
combine, one ON1 v2 launch a call on the card. The plain versions add
every running sum in the reference's order (``ops.rolling.blocked_cumsum``)
on any device and divide only by tensors (a CUDA division by a Python
number multiplies by its reciprocal), so on the card they are ON1 v2's
(and ON1's) values bit for bit.

"""

import torch

from . import rolling


def overlapping_sta_lta(signal, nsta, nlta):
    """Classic STA/LTA with overlapping windows (static ``nsta``/``nlta``):
    ON1 v2 on a CUDA tensor (``ops.cuda_onsets.sta_lta_cuda_v2``, which
    raises where it cannot run), :func:`overlapping_sta_lta_plain` on a CPU
    tensor."""

    if signal.is_cuda:
        from .cuda_onsets import sta_lta_cuda_v2

        return sta_lta_cuda_v2(signal, nsta, nlta, "classic")
    return overlapping_sta_lta_plain(signal, nsta, nlta)


def overlapping_sta_lta_plain(signal, nsta, nlta):
    """The plain version of :func:`overlapping_sta_lta` (and of ON1 v2's
    and ON1's classic rows), on any device."""

    n = signal.shape[-1]
    sta = rolling.trailing_window_sums(signal, nsta, reference_order=True)
    lta = rolling.trailing_window_sums(signal, nlta, reference_order=True)
    frac = nlta / nsta
    tiny = torch.finfo(signal.dtype).tiny
    ratio = torch.where(
        lta < tiny, 1.0, sta / torch.clamp(lta, min=tiny) * frac
    )
    valid = torch.arange(n, device=signal.device) >= (nlta - 1)
    return torch.where(valid, ratio, 1.0)


def centred_sta_lta(signal, nsta, nlta):
    """Centred STA/LTA: the STA window follows the LTA window. ON1 v2 on a
    CUDA tensor, :func:`centred_sta_lta_plain` on a CPU tensor."""

    if signal.is_cuda:
        from .cuda_onsets import sta_lta_cuda_v2

        return sta_lta_cuda_v2(signal, nsta, nlta, "centred")
    return centred_sta_lta_plain(signal, nsta, nlta)


def centred_sta_lta_plain(signal, nsta, nlta):
    """The plain version of :func:`centred_sta_lta` (and of ON1 v2's and
    ON1's centred rows), on any device."""

    n = signal.shape[-1]
    padded = rolling.padded_cumsum(signal, reference_order=True)
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


_PLAIN = {"classic": overlapping_sta_lta_plain,
          "centred": centred_sta_lta_plain}


def station_sta_lta(traces, offsets, nsta, nlta, position, transform, edges,
                    min_onset_value, out=None):
    """
    Locate's STA/LTA onsets of a phase: each row of ``traces`` [rows, T]
    transformed (:func:`signal_transform`), its STA/LTA at ``position``,
    the samples of ``edges`` (lo, hi) set to 1 (``[0, lo)`` and ``[hi,
    T)``; None: none) and each station's rows, ``offsets`` [stations + 1],
    combined (the root of their mean square, clamped to
    ``min_onset_value``). Returns [stations, T] (written to ``out`` where
    given). ON1 v2 in one launch on a CUDA tensor
    (``ops.cuda_onsets.station_sta_lta_cuda_v2``),
    :func:`station_sta_lta_plain` on a CPU tensor.

    """

    if traces.is_cuda:
        from .cuda_onsets import station_sta_lta_cuda_v2

        return station_sta_lta_cuda_v2(traces, offsets, nsta, nlta, position,
                                       transform, edges, min_onset_value,
                                       out)
    return station_sta_lta_plain(traces, offsets, nsta, nlta, position,
                                 transform, edges, min_onset_value, out)


def station_sta_lta_plain(traces, offsets, nsta, nlta, position, transform,
                          edges, min_onset_value, out=None):
    """The plain version of :func:`station_sta_lta` (and of ON1 v2's and
    ON1's stations mode), on any device."""

    if position not in _PLAIN:
        raise ValueError(f"Unknown STA/LTA position: {position}")
    onsets = _PLAIN[position](signal_transform(traces, transform), nsta, nlta)
    return combine_stations(onsets, offsets, edges, min_onset_value, out)


def combine_stations(onsets, offsets, edges, min_onset_value, out=None):
    """
    The per-station epilogue of locate's onsets, after the reference's
    ``calculate_onsets``: the samples of ``edges`` (lo, hi) of each row of
    ``onsets`` [rows, T] set to 1 (None: none), then for each station's
    rows ``[offsets[s], offsets[s + 1])`` the squares added in row order,
    divided by the row count, the square root and the clamp to
    ``min_onset_value``. Returns [stations, T] (``out`` where given).

    """

    if edges is not None:
        lo, hi = edges
        onsets = onsets.clone()
        onsets[:, :lo] = 1.0
        onsets[:, hi:] = 1.0
    squares = onsets * onsets
    rows = []
    for first, end in zip(offsets[:-1], offsets[1:]):
        acc = squares[first]
        for r in range(first + 1, end):
            acc = acc + squares[r]
        rows.append(torch.clamp(torch.sqrt(acc / torch.full_like(
            acc, end - first)), min=min_onset_value))
    combined = torch.stack(rows)
    if out is None:
        return combined
    return out.copy_(combined)


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
