# -*- coding: utf-8 -*-
"""
The wrappers of the static-window STA/LTA (classic or centred) and the
kurtosis onset on the card, one launch a call, in either output mode of
the sources: every row's onset (``ops.stalta``'s and ``ops.kurtosis``'
functions on a CUDA tensor, ``core.compat``), or each station's rows
combined (the onsets' ``calculate_onsets`` for locate and the standard
detect path). ON1 v2 and ON2 v2 (``csrc/locate_onsets_v2.cu``:
:func:`sta_lta_cuda_v2`, :func:`station_sta_lta_cuda_v2`,
:func:`kurtosis_onset_cuda_v2`, :func:`station_kurtosis_onset_cuda_v2`)
run on every path: a grid of row segments, without a workspace for rows
of at most 4,096 samples, with the blocked scan's upper levels published
through one for longer rows (the design is in the source). ON1 and ON2
(``csrc/locate_onsets.cu``, one block a row or station:
:func:`sta_lta_cuda`, :func:`station_sta_lta_cuda`,
:func:`kurtosis_onset_cuda`, :func:`station_kurtosis_onset_cuda`) are
their first forms, kept as the yardstick. The plain versions are
``ops.stalta``'s ``overlapping_sta_lta_plain``, ``centred_sta_lta_plain``
and ``station_sta_lta_plain``, and ``ops.kurtosis``'
``kurtosis_onset_plain`` and ``station_kurtosis_onset_plain``; the kernels
add every running sum in their order (``ops.rolling.blocked_cumsum``'s)
and round where they round.

Counterparts of the XLA code of the JAX package's
``ops/stalta.py::overlapping_sta_lta``, ``centred_sta_lta`` and
``ops/kurtosis.py::kurtosis_onset``; no Pallas kernel computes them.

"""

import functools

import torch

from .cuda_front_end import (
    _MODES,
    _POSITIONS,
    _double_halves,
    _on_card,
    stage_bytes,
)
from .cuda_migrate import launch_kernel
from .stalta import _envelope

# Launches of ON1, ON2, ON1 v2 and ON2 v2, counted by their wrappers where
# they launch
launches = {"onset_stalta": 0, "onset_kurtosis": 0,
            "onset_stalta_v2": 0, "onset_kurtosis_v2": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# The transform of rows mode: the samples as they are
_IDENTITY = _MODES["env"]
# Row lengths the kernels index with 32-bit ints (the centred STA adds a
# window length to a sample's index)
MAX_SAMPLES = 2**30


def reset_launches():
    for name in launches:
        launches[name] = 0


def unit_values(t, kurtosis):
    """Values of a unit's workspace (a row's, or a station's rows' in
    turn) at row length ``t``: the running sums of each power (one for
    ON1, four for ON2) at every sample and at every level of the blocked
    scan above the samples (the totals of each block of 16, of each block
    of 16 of those, ... down to at most 16), and for ON2 the kurtosis."""

    levels = stage_bytes(t, 1, 1)
    powers = 4 if kurtosis else 1
    return powers * (t + levels) + (t if kurtosis else 0)


def _rows(name, signal):
    """The checks of a call's rows but their device; returns (rows, t)."""

    if signal.dtype not in _SUFFIX:
        raise TypeError(f"{name} takes float32 or float64, not "
                        f"{signal.dtype}")
    if signal.dim() < 1 or signal.shape[-1] < 1 or signal.numel() == 0:
        raise ValueError(f"{name} takes rows of at least one sample, not "
                         f"{tuple(signal.shape)}")
    t = signal.shape[-1]
    rows = signal.numel() // t
    if t >= MAX_SAMPLES or rows >= 2**31:
        raise ValueError(f"{name} takes fewer than 2**31 rows of fewer "
                         f"than {MAX_SAMPLES} samples, not {rows} x {t}")
    return rows, t


def _offsets(name, offsets, rows):
    """Station offsets [units + 1] (a station's rows are [offsets[s],
    offsets[s + 1])) checked; returns them as a list of ints."""

    offsets = [int(o) for o in offsets]
    if (len(offsets) < 2 or offsets[0] != 0 or offsets[-1] != rows
            or any(b <= a for a, b in zip(offsets[:-1], offsets[1:]))):
        raise ValueError(f"{name}: offsets must rise from 0 to the {rows} "
                         f"rows, each station at least one, not {offsets}")
    return offsets


def _offsets_on(offsets, device):
    """The offsets as int32 on ``device``, copied from pinned memory and
    queued on the stream (a copy from pageable memory would wait for the
    stream's work)."""

    host = torch.tensor(offsets, dtype=torch.int32,
                        pin_memory=device.type == "cuda")
    return host.to(device, non_blocking=True)


def _edges(name, edges, t):
    """A station's samples set to 1 before the combine, ``[0, lo)`` and
    ``[hi, t)``, as (lo, hi); None: none."""

    if edges is None:
        return 0, t
    lo, hi = (int(e) for e in edges)
    if lo < 0 or not 0 <= hi <= t:
        raise ValueError(f"{name}: edges must be 0 <= lo and 0 <= hi <= "
                         f"{t}, not {(lo, hi)}")
    return lo, hi


def _out(name, out, units, t, signal):
    if out is None:
        return torch.empty((units, t), dtype=signal.dtype,
                           device=signal.device)
    if (out.dtype != signal.dtype or out.device != signal.device
            or tuple(out.shape) != (units, t) or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous {signal.dtype} "
                         f"[{units}, {t}] on {signal.device}, not "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    return out


@functools.lru_cache(maxsize=64)
def _workspace_bytes_v2(kurtosis, units, rows, t, itemsize):
    """Bytes of ON1 v2's (``kurtosis`` False) or ON2 v2's workspace at a
    call's shape (the kernel library's layout): 0 for rows of at most
    4,096 samples."""

    from quakemigrate_torch import _build

    return _build.load_library().qm_onset_v2_workspace_bytes(
        int(kurtosis), units, rows, t, itemsize)


def _launch(version, kurtosis, x, offsets, out, units, rows, t, *settings):
    """One launch of ON1 (``kurtosis`` False) or ON2, or of their v2
    (``version`` 2), on the ``rows`` rows of ``x``."""

    key = (("onset_kurtosis" if kurtosis else "onset_stalta")
           + ("_v2" if version == 2 else ""))
    if version == 2:
        nbytes = _workspace_bytes_v2(kurtosis, units, rows, t,
                                     x.element_size())
        ws = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
              if nbytes > 0 else None)
        shape = (None if ws is None else ws.data_ptr(), units, rows, t)
    else:
        ws_unit = unit_values(t, kurtosis)
        if ws_unit >= 2**31:
            raise ValueError(f"rows of {t} samples need {ws_unit} workspace "
                             "values a unit, more than the kernels index")
        ws = torch.empty(units * ws_unit, dtype=x.dtype, device=x.device)
        shape = (ws.data_ptr(), units, t, ws_unit)
    launch_kernel(f"qm_{key}_{_SUFFIX[x.dtype]}", x.device, x.data_ptr(),
                  None if offsets is None else offsets.data_ptr(),
                  out.data_ptr(), *shape, *settings)
    launches[key] += 1
    return out


def _sta_lta_settings(name, nsta, nlta, position):
    if position not in _POSITIONS:
        raise ValueError(f"Unknown STA/LTA position: {position}")
    nsta, nlta = int(nsta), int(nlta)
    if nsta < 1 or nlta < 1:
        raise ValueError(f"{name}: nsta ({nsta}) and nlta ({nlta}) must be "
                         ">= 1")
    # The static functions' frac: a Python float, rounded once to the type
    return nsta, nlta, _POSITIONS[position], _double_halves(nlta / nsta)


def _sta_lta(version, signal, nsta, nlta, position):
    name = "sta_lta_cuda" + ("_v2" if version == 2 else "")
    rows, t = _rows(name, signal)
    nsta, nlta, centred, frac = _sta_lta_settings(name, nsta, nlta, position)
    _on_card(name, signal)
    x = signal.contiguous()
    out = torch.empty_like(x)
    _launch(version, False, x, None, out, rows, rows, t, nsta, nlta,
            centred, _IDENTITY, 0, t, *frac, *_double_halves(1.0))
    return out


def sta_lta_cuda_v2(signal, nsta, nlta, position):
    """
    ON1 v2 on every row of a CUDA tensor ``signal`` [..., n] (float32 or
    float64), the STA/LTA of the samples as they are: ``position``
    "classic" (:func:`~quakemigrate_torch.ops.stalta.overlapping_sta_lta`)
    or "centred" (:func:`~quakemigrate_torch.ops.stalta.centred_sta_lta`).
    Returns the onsets in the input's dtype and shape. Raises on a CPU
    tensor, another dtype, an empty row, ``nsta`` or ``nlta`` below 1, or
    a failed launch.

    """

    return _sta_lta(2, signal, nsta, nlta, position)


def sta_lta_cuda(signal, nsta, nlta, position):
    """ON1, the yardstick of :func:`sta_lta_cuda_v2` (which the paths
    run): the same contract, one block a row."""

    return _sta_lta(1, signal, nsta, nlta, position)


def _station_sta_lta(version, traces, offsets, nsta, nlta, position,
                     transform, edges, min_onset_value, out):
    name = "station_sta_lta_cuda" + ("_v2" if version == 2 else "")
    if transform not in _MODES:
        raise ValueError(f"Unknown signal transform: {transform}")
    if traces.dim() != 2:
        raise ValueError(f"{name}: traces must be [rows, T], not "
                         f"{tuple(traces.shape)}")
    rows, t = _rows(name, traces)
    nsta, nlta, centred, frac = _sta_lta_settings(name, nsta, nlta, position)
    offsets = _offsets(name, offsets, rows)
    lo, hi = _edges(name, edges, t)
    _on_card(name, traces)
    out = _out(name, out, len(offsets) - 1, t, traces)
    x = traces.contiguous()
    if transform in ("env", "env_squared"):
        x = _envelope(x)
    return _launch(version, False, x, _offsets_on(offsets, x.device), out,
                   len(offsets) - 1, rows, t, nsta, nlta, centred,
                   _MODES[transform], lo, hi, *frac,
                   *_double_halves(min_onset_value))


def station_sta_lta_cuda_v2(traces, offsets, nsta, nlta, position,
                            transform, edges, min_onset_value, out=None):
    """
    ON1 v2 in stations mode on a CUDA tensor ``traces`` [rows, T]: each
    row's ``transform`` ("energy", "abs", "env", "env_squared"; the
    envelope's ``torch.fft`` calls before the kernel), its STA/LTA, the
    samples of ``edges`` (lo, hi) set to 1 (``[0, lo)`` and ``[hi, T)``;
    None: none), and each station's rows (``offsets`` [stations + 1])
    combined: the root of their mean square, clamped to
    ``min_onset_value``. One launch; returns ``out`` (a new [stations, T]
    tensor where None). Raises as :func:`sta_lta_cuda_v2`, and on bad
    offsets, edges, ``out`` or transform.

    """

    return _station_sta_lta(2, traces, offsets, nsta, nlta, position,
                            transform, edges, min_onset_value, out)


def station_sta_lta_cuda(traces, offsets, nsta, nlta, position, transform,
                         edges, min_onset_value, out=None):
    """ON1 in stations mode, the yardstick of
    :func:`station_sta_lta_cuda_v2`: the same contract, one block a
    station."""

    return _station_sta_lta(1, traces, offsets, nsta, nlta, position,
                            transform, edges, min_onset_value, out)


def _kurtosis_settings(name, nkurt, nsmooth):
    nkurt = int(nkurt)
    if nkurt < 1:
        raise ValueError(f"{name}: nkurt ({nkurt}) must be >= 1")
    # A window of at most one sample smooths nothing, as in the plain version
    return nkurt, max(int(nsmooth), 1)


def _kurtosis_onset(version, signal, nkurt, nsmooth):
    name = "kurtosis_onset_cuda" + ("_v2" if version == 2 else "")
    rows, t = _rows(name, signal)
    nkurt, nsmooth = _kurtosis_settings(name, nkurt, nsmooth)
    _on_card(name, signal)
    x = signal.contiguous()
    out = torch.empty_like(x)
    _launch(version, True, x, None, out, rows, rows, t, nkurt, nsmooth, 0,
            t, *_double_halves(1.0))
    return out


def kurtosis_onset_cuda_v2(signal, nkurt, nsmooth=1):
    """
    ON2 v2 on every row of a CUDA tensor ``signal`` [..., n] (float32 or
    float64): :func:`~quakemigrate_torch.ops.kurtosis.kurtosis_onset`.
    Returns the onsets in the input's dtype and shape. Raises on a CPU
    tensor, another dtype, an empty row, ``nkurt`` below 1, or a failed
    launch.

    """

    return _kurtosis_onset(2, signal, nkurt, nsmooth)


def kurtosis_onset_cuda(signal, nkurt, nsmooth=1):
    """ON2, the yardstick of :func:`kurtosis_onset_cuda_v2`: the same
    contract, one block a row."""

    return _kurtosis_onset(1, signal, nkurt, nsmooth)


def _station_kurtosis_onset(version, traces, offsets, nkurt, nsmooth, edges,
                            min_onset_value, out):
    name = "station_kurtosis_onset_cuda" + ("_v2" if version == 2 else "")
    if traces.dim() != 2:
        raise ValueError(f"{name}: traces must be [rows, T], not "
                         f"{tuple(traces.shape)}")
    rows, t = _rows(name, traces)
    nkurt, nsmooth = _kurtosis_settings(name, nkurt, nsmooth)
    offsets = _offsets(name, offsets, rows)
    lo, hi = _edges(name, edges, t)
    _on_card(name, traces)
    out = _out(name, out, len(offsets) - 1, t, traces)
    return _launch(version, True, traces.contiguous(),
                   _offsets_on(offsets, traces.device), out,
                   len(offsets) - 1, rows, t, nkurt, nsmooth, lo, hi,
                   *_double_halves(min_onset_value))


def station_kurtosis_onset_cuda_v2(traces, offsets, nkurt, nsmooth, edges,
                                   min_onset_value, out=None):
    """
    ON2 v2 in stations mode on a CUDA tensor ``traces`` [rows, T]: each
    row's kurtosis onset, the samples of ``edges`` set to 1 and each
    station's rows combined, as :func:`station_sta_lta_cuda_v2`. One
    launch; returns ``out``. Raises as :func:`kurtosis_onset_cuda_v2`, and
    on bad offsets, edges or ``out``.

    """

    return _station_kurtosis_onset(2, traces, offsets, nkurt, nsmooth, edges,
                                   min_onset_value, out)


def station_kurtosis_onset_cuda(traces, offsets, nkurt, nsmooth, edges,
                                min_onset_value, out=None):
    """ON2 in stations mode, the yardstick of
    :func:`station_kurtosis_onset_cuda_v2`: the same contract, one block a
    station."""

    return _station_kurtosis_onset(1, traces, offsets, nkurt, nsmooth, edges,
                                   min_onset_value, out)


def blocks_per_sm(kurtosis, dtype, device, version=1):
    """Resident blocks per SM of ON1 (``kurtosis`` False) or ON2, or of
    their v2 (``version`` 2, at its long rows' shared memory), in
    ``dtype`` on ``device``."""

    from .cuda_migrate import blocks_per_sm as query

    name = "qm_onset_v2_blocks_per_sm" if version == 2 else (
        "qm_onset_blocks_per_sm")
    return query(name, device, int(kurtosis), int(dtype == torch.float64))
