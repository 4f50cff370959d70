# -*- coding: utf-8 -*-
"""
Rolling-kurtosis onset functions in plain PyTorch, on the device of their
input: the port of quakemigrate_tpu.ops.kurtosis.

A trailing-window kurtosis characteristic function (Baillard et al.,
2014), rectified to its positive gradient and shifted so the output is a
positive function with baseline 1, directly usable in the geometric-mean
coalescence stack. The moments come from cumulative sums
(``ops.rolling.trailing_window_sums``, in the reference's order of
additions on every device: the card's values are then the CPU's), batched
over channels and over the four powers.

The arithmetic follows the reference term by term: powers are products
(``x**3`` is ``x * (x * x)``, as JAX's integer power forms it), the
central moments are formed in the reference's order, and the box
smoothing is a sum of shifted rows, each scaled by ``1 / nsmooth``, in
``numpy.convolve``'s ``mode="same"`` alignment (a kernel of even length
``m`` covers ``[i - m // 2, i + m // 2 - 1]``). No convolution routine is
used: cuDNN would run a float32 convolution in TF32.

:func:`kurtosis_onset` and :func:`station_kurtosis_onset` (locate's onsets
of a phase, with the per-station combine) run ON2 v2 (``ops.cuda_onsets``)
on a CUDA tensor and their plain versions on a CPU tensor; those divide
only by tensors (a CUDA division by a Python number multiplies by its
reciprocal), so on the card they are ON2 v2's (and ON2's) values bit for
bit.

"""

import torch

from .rolling import trailing_window_sums
from .stalta import combine_stations


def _powers(x):
    """(x, x^2, x^3, x^4) as JAX's integer power forms them, stacked on a
    new leading axis."""

    x2 = x * x
    return torch.stack([x, x2, x * x2, x2 * x2])


def _kurtosis_from_sums(sums, n, dtype):
    """Fisher kurtosis (normal -> 0) from trailing sums of x, x^2, x^3
    and x^4 over windows of ``n`` samples (a 0-dim or a [rows, 1]
    tensor), with the reference's degenerate-window gate: a window whose
    variance is below 1e-12 of its mean square is flattened to 0."""

    s1, s2, s3, s4 = sums
    mean = s1 / n
    mean2 = mean * mean
    m2 = s2 / n - mean2
    m4 = (
        s4 / n
        - 4 * mean * (s3 / n)
        + 6 * mean2 * (s2 / n)
        - 3 * (mean2 * mean2)
    )
    tiny = torch.finfo(dtype).tiny
    power = s2 / n
    m2f = torch.clamp(m2, min=tiny ** 0.5)
    raw = m4 / (m2f * m2f) - 3.0
    return torch.where(m2 > power * 1e-12, raw, 0.0)


def rolling_kurtosis(signal, nkurt):
    """
    Trailing-window sample kurtosis (Fisher, i.e. normal -> 0) of a
    signal, batched over leading dimensions. The first ``nkurt - 1``
    samples are 0.

    """

    sums = trailing_window_sums(_powers(signal), int(nkurt),
                                reference_order=True)
    n = torch.full((), float(nkurt), dtype=signal.dtype, device=signal.device)
    kurt = _kurtosis_from_sums(sums, n, signal.dtype)
    valid = torch.arange(signal.shape[-1], device=signal.device) >= nkurt - 1
    return torch.where(valid, kurt, 0.0)


def smooth_same(cf, nsmooth):
    """Box smoothing of the rows of ``cf`` [..., T] over ``nsmooth``
    samples, as ``numpy.convolve(row, ones(nsmooth) / nsmooth,
    mode="same")`` aligns it (zeros beyond the row)."""

    weight = 1.0 / nsmooth
    padded = torch.nn.functional.pad(cf, (nsmooth // 2, (nsmooth - 1) // 2))
    t = cf.shape[-1]
    out = padded[..., 0:t] * weight
    for j in range(1, nsmooth):
        out = out + padded[..., j:j + t] * weight
    return out


def _onset_from_kurtosis(kurt, nsmooth):
    """1 + the positive gradient of ``kurt`` (the first sample's
    gradient 0), box-smoothed over ``nsmooth`` samples where it is > 1."""

    grad = torch.diff(kurt, dim=-1, prepend=kurt[..., :1])
    cf = torch.clamp(grad, min=0.0)
    if nsmooth > 1:
        cf = smooth_same(cf, nsmooth)
    return 1.0 + cf


def kurtosis_onset(signal, nkurt, nsmooth=1):
    """
    Kurtosis characteristic function: the positive gradient of the
    rolling kurtosis (optionally smoothed over ``nsmooth`` samples),
    shifted to baseline 1. Kurtosis is dimensionless, so the function is
    scale-free across stations without further normalisation. ON2 v2 on a
    CUDA tensor (``ops.cuda_onsets.kurtosis_onset_cuda_v2``, which raises
    where it cannot run), :func:`kurtosis_onset_plain` on a CPU tensor.

    """

    if signal.is_cuda:
        from .cuda_onsets import kurtosis_onset_cuda_v2

        return kurtosis_onset_cuda_v2(signal, nkurt, nsmooth)
    return kurtosis_onset_plain(signal, nkurt, nsmooth)


def kurtosis_onset_plain(signal, nkurt, nsmooth=1):
    """The plain version of :func:`kurtosis_onset` (and of ON2 v2's and
    ON2's rows), on any device."""

    return _onset_from_kurtosis(rolling_kurtosis(signal, nkurt), nsmooth)


def station_kurtosis_onset(traces, offsets, nkurt, nsmooth, edges,
                           min_onset_value, out=None):
    """
    Locate's kurtosis onsets of a phase: each row of ``traces`` [rows, T]
    through :func:`kurtosis_onset`, the samples of ``edges`` (lo, hi) set
    to 1 and each station's rows, ``offsets`` [stations + 1], combined
    (``ops.stalta.combine_stations``). Returns [stations, T] (written to
    ``out`` where given). ON2 v2 in one launch on a CUDA tensor
    (``ops.cuda_onsets.station_kurtosis_onset_cuda_v2``),
    :func:`station_kurtosis_onset_plain` on a CPU tensor.

    """

    if traces.is_cuda:
        from .cuda_onsets import station_kurtosis_onset_cuda_v2

        return station_kurtosis_onset_cuda_v2(traces, offsets, nkurt, nsmooth,
                                              edges, min_onset_value, out)
    return station_kurtosis_onset_plain(traces, offsets, nkurt, nsmooth,
                                        edges, min_onset_value, out)


def station_kurtosis_onset_plain(traces, offsets, nkurt, nsmooth, edges,
                                 min_onset_value, out=None):
    """The plain version of :func:`station_kurtosis_onset` (and of ON2 v2's
    and ON2's stations mode), on any device."""

    return combine_stations(kurtosis_onset_plain(traces, nkurt, nsmooth),
                            offsets, edges, min_onset_value, out)


def kurtosis_cf_rows(signal, nkurt_rows, nsmooth):
    """
    The kurtosis characteristic function of the rows of ``signal``
    [rows, T] with a per-row window length ``nkurt_rows`` (an integer
    tensor [rows]; rows may belong to different phases), for the fused
    detect window. Row by row it is :func:`kurtosis_onset`.

    """

    nkurt_rows = torch.as_tensor(nkurt_rows, device=signal.device)
    n_col = nkurt_rows[:, None].to(signal.dtype)
    rows, t = signal.shape
    sums = trailing_window_sums(_powers(signal).reshape(4 * rows, t),
                                nkurt_rows.repeat(4),
                                reference_order=True).reshape(4, rows, t)
    kurt = _kurtosis_from_sums(sums, n_col, signal.dtype)
    idx = torch.arange(signal.shape[-1], device=signal.device)
    kurt = torch.where(idx[None, :] >= nkurt_rows[:, None] - 1, kurt, 0.0)
    return _onset_from_kurtosis(kurt, nsmooth)
