# -*- coding: utf-8 -*-
"""
The wrappers of the onset front ends of detect's fused window on the
card, one launch a window. FE1 v2 (:func:`fused_onsets_cuda_v2`, the
STA/LTA front end) and FE2 v2 (:func:`fused_kurtosis_onsets_cuda_v2`, the
kurtosis front end), ``csrc/front_end_v2.cu``, run on the detect paths: a
grid of row segments whose tiles publish the blocked scan's levels to a
workspace of the launch (the design is in the source), for any window
length. FE1 and FE2 (:func:`fused_onsets_cuda`,
:func:`fused_kurtosis_onsets_cuda`, ``csrc/front_end.cu``, one block a
slot, rows whose scan levels fit a block's shared memory) are their first
forms, kept as the yardstick. The plain versions are
:func:`quakemigrate_torch.ops.scan_window.fused_onsets` and
:func:`quakemigrate_torch.ops.scan_window.fused_kurtosis_onsets`. All four
add every running sum in the reference's order (``ops.rolling``'s
``blocked_cumsum``) and round where their plain versions round.

Counterparts of the XLA code of the JAX package's
``ops/scan_window.py::fused_onsets`` and ``fused_kurtosis_onsets``; no
Pallas kernel computes them.

"""

import functools
import struct

import torch

from .cuda_migrate import launch_kernel
from .rolling import SCAN_BLOCK
from .stalta import _envelope

# Launches of FE1, FE2, FE1 v2 and FE2 v2, counted by their wrappers where
# they launch
launches = {"front_end_stalta": 0, "front_end_kurtosis": 0,
            "front_end_stalta_v2": 0, "front_end_kurtosis_v2": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# The transforms FE1 applies to its input: the square, the magnitude, or
# none (the envelope, taken before the kernel)
_MODES = {"energy": 0, "abs": 1, "env": 2, "env_squared": 0}
_POSITIONS = {"classic": 0, "centred": 1}
# Shared memory a block may hold on the card (227 KiB on Hopper): FE1 and
# FE2 stage a row's scan levels there
MAX_STAGE_BYTES = 232_448


def reset_launches():
    for name in launches:
        launches[name] = 0


def stage_bytes(t, stretches, itemsize):
    """Shared memory of a launch of FE1 or FE2: the levels of the blocked
    scan (the totals of each block of 16, of each block of 16 of those,
    ... down to at most 16) of each of ``stretches`` rows of ``t``
    samples."""

    n = -(-t // SCAN_BLOCK)
    total = n
    while n > SCAN_BLOCK:
        n = -(-n // SCAN_BLOCK)
        total += n
    return total * stretches * itemsize


def _double_halves(value):
    """A double as the two 32-bit ints (low, high) the C entries take."""

    return struct.unpack("<ii", struct.pack("<d", float(value)))


def _lengths(n, n_slots, label):
    """Window lengths [n_slots] as the kernel reads them: int32 on the
    card. Lengths on the host are checked (each at least 1) and copied
    there; lengths on the card are checked by the kernel, which gives a
    live slot with a length below 1 NaN onsets."""

    if torch.is_tensor(n) and n.is_cuda:
        if n.dtype != torch.int32 or n.shape != (n_slots,):
            raise ValueError(f"{label} must be int32 [{n_slots}], not "
                             f"{n.dtype} {tuple(n.shape)}")
        return n.contiguous()
    n = torch.as_tensor(n)
    if n.dtype.is_floating_point or n.shape != (n_slots,):
        raise ValueError(f"{label} must be integers [{n_slots}], not "
                         f"{n.dtype} {tuple(n.shape)}")
    if bool((n < 1).any()):
        raise ValueError(f"{label} must be >= 1, not {n.tolist()}")
    return n.to(torch.int32)


def _check_block(name, channels, chan_mask, slot_mask):
    """The checks every wrapper makes of the block; returns (n_slots,
    c_max, t)."""

    if channels.dtype not in _SUFFIX:
        raise TypeError(f"{name} takes float32 or float64, not "
                        f"{channels.dtype}")
    if channels.dim() != 3 or 0 in channels.shape:
        raise ValueError(f"{name}: channels must be [n_slots, C_max, T], "
                         f"not {tuple(channels.shape)}")
    n_slots, c_max, t = channels.shape
    for label, a, shape in (("chan_mask", chan_mask, (n_slots, c_max)),
                            ("slot_mask", slot_mask, (n_slots,))):
        if a.dtype != channels.dtype or a.shape != shape:
            raise ValueError(f"{name}: {label} must be {channels.dtype} "
                             f"{list(shape)}, not {a.dtype} "
                             f"{tuple(a.shape)}")
    if channels.numel() >= 2**31:
        raise ValueError(f"{name} takes fewer than 2**31 samples, not "
                         f"{channels.numel()}")
    return n_slots, c_max, t


def _check_stage(name, channels, powers):
    """FE1's and FE2's limit: the blocked scan's levels of ``powers``
    running sums a channel must fit a block's shared memory."""

    n_slots, c_max, t = channels.shape
    need = stage_bytes(t, powers * c_max, channels.element_size())
    if need > MAX_STAGE_BYTES:
        raise ValueError(
            f"{name}: the blocked scan's levels of {powers * c_max} rows of "
            f"{t} samples need {need} bytes of shared memory, more than a "
            f"block holds ({MAX_STAGE_BYTES})")


@functools.lru_cache(maxsize=64)
def _workspace_bytes(kurtosis, n_slots, c_max, t, itemsize):
    """Bytes of FE1 v2's (kurtosis 0) or FE2 v2's workspace at a block's
    shape (the kernel library's layout)."""

    from quakemigrate_torch import _build

    return _build.load_library().qm_front_end_v2_workspace_bytes(
        kurtosis, n_slots, c_max, t, itemsize)


def _on_card(name, *tensors):
    if not all(torch.is_tensor(a) and a.is_cuda for a in tensors):
        raise ValueError(f"{name} takes CUDA tensors")
    device = tensors[0].device
    if any(a.device != device for a in tensors):
        raise ValueError(f"{name}: the block's tensors lie on more than one "
                         "device")
    return device


def _fused_onsets(version, channels, chan_mask, slot_mask, nsta, nlta,
                  position, transform, min_onset_value):
    name = "fused_onsets_cuda" + ("_v2" if version == 2 else "")
    if position not in _POSITIONS:
        raise ValueError(f"Unknown STA/LTA position: {position}")
    if transform not in _MODES:
        raise ValueError(f"Unknown signal transform: {transform}")
    n_slots, c_max, t = _check_block(name, channels, chan_mask, slot_mask)
    if version == 1:
        _check_stage(name, channels, 1)
    nsta = _lengths(nsta, n_slots, "nsta")
    nlta = _lengths(nlta, n_slots, "nlta")
    device = _on_card(name, channels, chan_mask, slot_mask)
    nsta = nsta.to(device, non_blocking=True)
    nlta = nlta.to(device, non_blocking=True)
    x = channels.contiguous()
    if transform in ("env", "env_squared"):
        x = _envelope(x.reshape(n_slots * c_max, t))
    out = torch.empty((n_slots, t), dtype=x.dtype, device=device)
    available = torch.empty((), dtype=x.dtype, device=device)
    ptrs = [x.data_ptr(), chan_mask.contiguous().data_ptr(),
            slot_mask.contiguous().data_ptr(), nsta.data_ptr(),
            nlta.data_ptr(), out.data_ptr(), available.data_ptr()]
    if version == 2:
        workspace = torch.empty(
            _workspace_bytes(0, n_slots, c_max, t, x.element_size()),
            dtype=torch.uint8, device=device)
        ptrs.append(workspace.data_ptr())
    key = "front_end_stalta" + ("_v2" if version == 2 else "")
    launch_kernel(f"qm_{key}_{_SUFFIX[x.dtype]}", device, *ptrs, n_slots,
                  c_max, t, _POSITIONS[position], _MODES[transform],
                  *_double_halves(min_onset_value))
    launches[key] += 1
    return out, available


def fused_onsets_cuda_v2(channels, chan_mask, slot_mask, nsta, nlta,
                         position, transform, min_onset_value):
    """
    FE1 v2 on a block on the card: the STA/LTA front end of
    :func:`~quakemigrate_torch.ops.scan_window.fused_onsets`, one launch
    (after the envelope's ``torch.fft`` calls for ``transform`` "env" and
    "env_squared"), at any window length. Returns (combined [n_slots, T],
    available, a 0-dim tensor the kernel writes), in the channels' dtype.
    Raises on a CPU tensor, a dtype other than float32 or float64, a shape
    the kernel does not take, a window length below 1 given on the host,
    or a failed launch.

    """

    return _fused_onsets(2, channels, chan_mask, slot_mask, nsta, nlta,
                         position, transform, min_onset_value)


def fused_onsets_cuda(channels, chan_mask, slot_mask, nsta, nlta, position,
                      transform, min_onset_value):
    """
    FE1, the yardstick of :func:`fused_onsets_cuda_v2` (which the detect
    paths run): the same contract, one block a slot; also raises where the
    row's scan levels do not fit a block's shared memory.

    """

    return _fused_onsets(1, channels, chan_mask, slot_mask, nsta, nlta,
                         position, transform, min_onset_value)


def _fused_kurtosis_onsets(version, channels, chan_mask, slot_mask, nkurt,
                           nsmooth, taper_pad, min_onset_value):
    name = "fused_kurtosis_onsets_cuda" + ("_v2" if version == 2 else "")
    nsmooth, taper_pad = int(nsmooth), int(taper_pad)
    if nsmooth < 1 or taper_pad < 0:
        raise ValueError(f"{name}: nsmooth ({nsmooth}) must be >= 1 and "
                         f"taper_pad ({taper_pad}) >= 0")
    n_slots, c_max, t = _check_block(name, channels, chan_mask, slot_mask)
    if version == 1:
        _check_stage(name, channels, 4)
    nkurt = _lengths(nkurt, n_slots, "nkurt")
    device = _on_card(name, channels, chan_mask, slot_mask)
    nkurt = nkurt.to(device, non_blocking=True)
    x = channels.contiguous()
    out = torch.empty((n_slots, t), dtype=x.dtype, device=device)
    available = torch.empty((), dtype=x.dtype, device=device)
    ptrs = [x.data_ptr(), chan_mask.contiguous().data_ptr(),
            slot_mask.contiguous().data_ptr(), nkurt.data_ptr()]
    if version == 2:
        workspace = torch.empty(
            _workspace_bytes(1, n_slots, c_max, t, x.element_size()),
            dtype=torch.uint8, device=device)
        ptrs += [out.data_ptr(), available.data_ptr(), workspace.data_ptr()]
    else:
        work = torch.empty_like(x)
        ptrs += [work.data_ptr(), out.data_ptr(), available.data_ptr()]
    key = "front_end_kurtosis" + ("_v2" if version == 2 else "")
    launch_kernel(f"qm_{key}_{_SUFFIX[x.dtype]}", device, *ptrs, n_slots,
                  c_max, t, nsmooth, taper_pad,
                  *_double_halves(min_onset_value))
    launches[key] += 1
    return out, available


def fused_kurtosis_onsets_cuda_v2(channels, chan_mask, slot_mask, nkurt,
                                  nsmooth, taper_pad, min_onset_value):
    """
    FE2 v2 on a block on the card: the kurtosis front end of
    :func:`~quakemigrate_torch.ops.scan_window.fused_kurtosis_onsets`, one
    launch, at any window length. Returns (combined [n_slots, T],
    available, a 0-dim tensor the kernel writes), in the channels' dtype.
    Raises on a CPU tensor, a dtype other than float32 or float64, a shape
    the kernel does not take, ``nsmooth`` below 1, ``taper_pad`` below 0,
    a window length below 1 given on the host, or a failed launch.

    """

    return _fused_kurtosis_onsets(2, channels, chan_mask, slot_mask, nkurt,
                                  nsmooth, taper_pad, min_onset_value)


def fused_kurtosis_onsets_cuda(channels, chan_mask, slot_mask, nkurt,
                               nsmooth, taper_pad, min_onset_value):
    """
    FE2, the yardstick of :func:`fused_kurtosis_onsets_cuda_v2` (which the
    detect paths run): the same contract, one block a slot; also raises
    where the rows' scan levels do not fit a block's shared memory.

    """

    return _fused_kurtosis_onsets(1, channels, chan_mask, slot_mask, nkurt,
                                  nsmooth, taper_pad, min_onset_value)
