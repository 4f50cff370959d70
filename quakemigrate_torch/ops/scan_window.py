# -*- coding: utf-8 -*-
"""
Fused detect window: signal transform -> STA/LTA -> multi-component RMS
combine -> onset clip -> migration -> per-sample grid reduction ->
normalisation, on one device, from a fixed-shape channel block.

Counterpart of quakemigrate_tpu.ops.scan_window. Inputs are organised
by canonical (phase, station) slot, in the layout that
``STALTAOnset.prepare_device_inputs`` builds:

    channels  [n_slots, C_max, T]  pre-processed waveforms (zeros when
                                   absent)
    chan_mask [n_slots, C_max]     1.0 for live channels
    slot_mask [n_slots]            1.0 for slots with >= 1 live channel
    nsta/nlta [n_slots]            STA/LTA window lengths in samples

"""

import numpy as np
import torch

from .migrate import DEFAULT_TILE, detect_reduce
from .rolling import padded_cumsum, trailing_window_sums
from .stalta import signal_transform


def _sta_lta_dynamic(signal, nsta, nlta, position):
    """
    Batched STA/LTA with per-row window lengths (rows may belong to
    different phases); ``position`` is "classic" or "centred". Semantics
    match ops.stalta.

    """

    if position not in ("classic", "centred"):
        raise ValueError(f"Unknown STA/LTA position: {position}")

    t = signal.shape[-1]
    idx = torch.arange(t, device=signal.device)[None, :]
    tiny = torch.finfo(signal.dtype).tiny
    nsta_col = nsta[:, None]
    nlta_col = nlta[:, None]
    frac = nlta_col.to(signal.dtype) / nsta_col.to(signal.dtype)

    if position == "classic":
        sta = trailing_window_sums(signal, nsta)
        lta = trailing_window_sums(signal, nlta)
        ratio = torch.where(
            lta < tiny, 1.0, sta / torch.clamp(lta, min=tiny) * frac
        )
        return torch.where(idx >= (nlta_col - 1), ratio, 1.0)

    # centred: lta trails, sta leads
    padded = padded_cumsum(signal)
    hi = padded[..., 1:]
    lo_idx = torch.clamp(idx + 1 - nlta_col, min=0)
    lta = hi - torch.gather(padded, -1, lo_idx)
    sta_hi_idx = torch.clamp(idx + 1 + nsta_col, max=t)
    sta = torch.gather(padded, -1, sta_hi_idx) - hi
    ratio = torch.where(
        lta <= 0.0, 1.0, sta / torch.clamp(lta, min=tiny) * frac
    )
    valid = (idx >= (nlta_col - 1)) & (idx < t - nsta_col)
    return torch.where(valid, ratio, 1.0)


def fused_onsets(
    channels, chan_mask, slot_mask, nsta, nlta,
    position, transform, min_onset_value,
):
    """
    Onset front end of the fused window: signal transform -> per-slot
    STA/LTA -> RMS channel combine -> clip. Returns
    (combined [n_slots, T], available 0-dim tensor).

    """

    n_slots, c_max, t = channels.shape
    rows = signal_transform(channels.reshape(n_slots * c_max, t), transform)

    nsta_rows = torch.repeat_interleave(nsta, c_max)
    nlta_rows = torch.repeat_interleave(nlta, c_max)
    onsets_rows = _sta_lta_dynamic(rows, nsta_rows, nlta_rows, position)

    # RMS combine of the live channels per slot, then clip
    onsets_c = onsets_rows.reshape(n_slots, c_max, t)
    weights = chan_mask[..., None]
    n_live = torch.clamp(chan_mask.sum(dim=1), min=1.0)[:, None]
    combined = torch.sqrt((onsets_c**2 * weights).sum(dim=1) / n_live)
    combined = torch.clamp(combined, min=min_onset_value)
    # Dead slots -> onset of ones (log-domain zero; excluded via slot_mask)
    combined = torch.where(slot_mask[:, None] == 1.0, combined, 1.0)

    return combined, slot_mask.sum()


def detect_window_fused(
    channels, chan_mask, slot_mask, nsta, nlta, traveltimes,
    position, transform, min_onset_value, fsmp, nsamples,
    n_nodes_real=None, tile=DEFAULT_TILE,
):
    """
    One detect window in plain PyTorch, with the flat-order migration of
    ops.migrate. Returns (max_coa, max_norm_coa, max_idx), each [S].

    """

    combined, available = fused_onsets(
        channels, chan_mask, slot_mask, nsta, nlta,
        position, transform, min_onset_value,
    )
    n_real = traveltimes.shape[0] if n_nodes_real is None else n_nodes_real
    max_coa, max_idx, coa_sum = detect_reduce(
        combined, traveltimes, slot_mask, available, fsmp, nsamples,
        n_real, tile,
    )
    return max_coa, max_coa * n_real / coa_sum, max_idx


def detect_window_fused_cuda(
    channels, chan_mask, slot_mask, nsta, nlta, detector,
    position, transform, min_onset_value, n_nodes_real,
):
    """
    One detect window with the migrate-and-reduce of ``detector`` (an
    ops.cuda_migrate.CudaDetect or CudaDetectVPU, which carries fsmp and
    nsamples) in place of the flat-order reduction. Same contract as
    :func:`detect_window_fused`; argmax ties follow brick order.

    """

    combined, available = fused_onsets(
        channels, chan_mask, slot_mask, nsta, nlta,
        position, transform, min_onset_value,
    )
    max_coa, max_idx, coa_sum = detector.reduce(combined, slot_mask,
                                                available)
    return max_coa, max_coa * n_nodes_real / coa_sum, max_idx


def pack_detect_window(max_coa, max_norm_coa, max_idx):
    """
    Pack a window's three per-sample outputs into ONE integer [3, S]
    tensor, so the host fetches each window with a single copy. The
    coalescence floats are bit-cast into same-width integers (float bits
    in integer lanes: nothing on the way can flush or canonicalise them).

    """

    int_dtype = torch.int64 if max_coa.dtype == torch.float64 else torch.int32
    return torch.stack([
        max_coa.view(int_dtype),
        max_norm_coa.view(int_dtype),
        max_idx.to(int_dtype),
    ])


def unpack_detect_window(packed):
    """Host-side inverse of :func:`pack_detect_window` (numpy, or a CPU
    tensor; a CUDA tensor raises: fetch it explicitly first)."""

    packed = np.asarray(packed)
    float_dtype = np.float64 if packed.dtype == np.int64 else np.float32
    max_coa = np.ascontiguousarray(packed[0]).view(float_dtype)
    max_norm = np.ascontiguousarray(packed[1]).view(float_dtype)
    return max_coa, max_norm, packed[2].astype(np.int32, copy=False)
