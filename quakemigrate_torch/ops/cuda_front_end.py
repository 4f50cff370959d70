# -*- coding: utf-8 -*-
"""
The wrappers of FE1 and FE2, ``csrc/front_end.cu``: the onset front ends
of detect's fused window on the card, one launch a window (the design is
in the source). FE1 is :func:`fused_onsets_cuda`, the STA/LTA front end,
whose plain version is :func:`quakemigrate_torch.ops.scan_window.fused_onsets`;
FE2 is :func:`fused_kurtosis_onsets_cuda`, the kurtosis front end, whose
plain version is
:func:`quakemigrate_torch.ops.scan_window.fused_kurtosis_onsets`. Both
add every running sum in the reference's order (``ops.rolling``'s
``blocked_cumsum``) and round where their plain versions round.

Counterparts of the XLA code of the JAX package's
``ops/scan_window.py::fused_onsets`` and ``fused_kurtosis_onsets``; no
Pallas kernel computes them.

"""

import struct

import torch

from .cuda_migrate import launch_kernel
from .rolling import SCAN_BLOCK
from .stalta import _envelope

# Launches of FE1 and FE2, counted by their wrappers where they launch
launches = {"front_end_stalta": 0, "front_end_kurtosis": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# The transforms FE1 applies to its input: the square, the magnitude, or
# none (the envelope, taken before the kernel)
_MODES = {"energy": 0, "abs": 1, "env": 2, "env_squared": 0}
_POSITIONS = {"classic": 0, "centred": 1}
# Shared memory a block may hold on the card (227 KiB on Hopper)
MAX_STAGE_BYTES = 232_448


def reset_launches():
    for name in launches:
        launches[name] = 0


def stage_bytes(t, stretches, itemsize):
    """Shared memory of a launch: the levels of the blocked scan (the
    totals of each block of 16, of each block of 16 of those, ... down to
    at most 16) of each of ``stretches`` rows of ``t`` samples."""

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


def _check_block(name, channels, chan_mask, slot_mask, powers):
    """The checks both wrappers make of the block, whose kernel scans
    ``powers`` running sums a channel; returns (n_slots, c_max, t)."""

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
    need = stage_bytes(t, powers * c_max, channels.element_size())
    if need > MAX_STAGE_BYTES:
        raise ValueError(
            f"{name}: the blocked scan's levels of {powers * c_max} rows of "
            f"{t} samples need {need} bytes of shared memory, more than a "
            f"block holds ({MAX_STAGE_BYTES})")
    return n_slots, c_max, t


def _on_card(name, *tensors):
    if not all(torch.is_tensor(a) and a.is_cuda for a in tensors):
        raise ValueError(f"{name} takes CUDA tensors")
    device = tensors[0].device
    if any(a.device != device for a in tensors):
        raise ValueError(f"{name}: the block's tensors lie on more than one "
                         "device")
    return device


def fused_onsets_cuda(channels, chan_mask, slot_mask, nsta, nlta, position,
                      transform, min_onset_value):
    """
    FE1 on a block on the card: the STA/LTA front end of
    :func:`~quakemigrate_torch.ops.scan_window.fused_onsets`, one launch
    (after the envelope's ``torch.fft`` calls for ``transform`` "env" and
    "env_squared"). Returns (combined [n_slots, T], available, a 0-dim
    tensor the kernel writes), in the channels' dtype. Raises on a CPU
    tensor, a dtype other than float32 or float64, a shape the kernel does
    not take, a window length below 1 given on the host, or a failed
    launch.

    """

    name = "fused_onsets_cuda"
    if position not in _POSITIONS:
        raise ValueError(f"Unknown STA/LTA position: {position}")
    if transform not in _MODES:
        raise ValueError(f"Unknown signal transform: {transform}")
    n_slots, c_max, t = _check_block(name, channels, chan_mask, slot_mask,
                                     1)
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
    launch_kernel(f"qm_front_end_stalta_{_SUFFIX[x.dtype]}", device,
                  x.data_ptr(), chan_mask.contiguous().data_ptr(),
                  slot_mask.contiguous().data_ptr(), nsta.data_ptr(),
                  nlta.data_ptr(), out.data_ptr(), available.data_ptr(),
                  n_slots, c_max, t, _POSITIONS[position], _MODES[transform],
                  *_double_halves(min_onset_value))
    launches["front_end_stalta"] += 1
    return out, available


def fused_kurtosis_onsets_cuda(channels, chan_mask, slot_mask, nkurt,
                               nsmooth, taper_pad, min_onset_value):
    """
    FE2 on a block on the card: the kurtosis front end of
    :func:`~quakemigrate_torch.ops.scan_window.fused_kurtosis_onsets`, one
    launch. Returns (combined [n_slots, T], available, a 0-dim tensor the
    kernel writes), in the channels' dtype. Raises on a CPU tensor, a
    dtype other than float32 or float64, a shape the kernel does not take,
    ``nsmooth`` below 1, ``taper_pad`` below 0, a window length below 1
    given on the host, or a failed launch.

    """

    name = "fused_kurtosis_onsets_cuda"
    nsmooth, taper_pad = int(nsmooth), int(taper_pad)
    if nsmooth < 1 or taper_pad < 0:
        raise ValueError(f"{name}: nsmooth ({nsmooth}) must be >= 1 and "
                         f"taper_pad ({taper_pad}) >= 0")
    n_slots, c_max, t = _check_block(name, channels, chan_mask, slot_mask,
                                     4)
    nkurt = _lengths(nkurt, n_slots, "nkurt")
    device = _on_card(name, channels, chan_mask, slot_mask)
    nkurt = nkurt.to(device, non_blocking=True)
    x = channels.contiguous()
    work = torch.empty_like(x)
    out = torch.empty((n_slots, t), dtype=x.dtype, device=device)
    available = torch.empty((), dtype=x.dtype, device=device)
    launch_kernel(f"qm_front_end_kurtosis_{_SUFFIX[x.dtype]}", device,
                  x.data_ptr(), chan_mask.contiguous().data_ptr(),
                  slot_mask.contiguous().data_ptr(), nkurt.data_ptr(),
                  work.data_ptr(), out.data_ptr(), available.data_ptr(),
                  n_slots, c_max, t, nsmooth, taper_pad,
                  *_double_halves(min_onset_value))
    launches["front_end_kurtosis"] += 1
    return out, available
