# -*- coding: utf-8 -*-
"""
Fused detect window: the onset front end (signal transform -> STA/LTA,
or the kurtosis characteristic function -> edge neutralisation) ->
multi-component RMS combine -> onset clip -> migration -> per-sample
grid reduction -> normalisation, on one device, from a fixed-shape
channel block.

Counterpart of quakemigrate_tpu.ops.scan_window. Inputs are organised
by canonical (phase, station) slot, in the layout that the onset's
``prepare_device_inputs`` builds:

    channels  [n_slots, C_max, T]  pre-processed waveforms (zeros when
                                   absent)
    chan_mask [n_slots, C_max]     1.0 for live channels
    slot_mask [n_slots]            1.0 for slots with >= 1 live channel

then the onset's per-slot arguments: ``nsta, nlta`` [n_slots] (STA/LTA
window lengths in samples) or ``nkurt`` [n_slots] (kurtosis window
lengths). A front end (:func:`stalta_front_end`,
:func:`kurtosis_front_end`) maps such a block to (combined onsets
[n_slots, T], available): on a block on the card FE1 v2 or FE2 v2
(``ops.cuda_front_end``, one launch a window), on a CPU block the plain
version (:func:`fused_onsets`, :func:`fused_kurtosis_onsets`), which
adds every running sum in the reference's order on any device, so that
the kernels have an exact plain version on the card too.
:func:`detect_window` and :func:`detect_window_cuda` run any front end's
window. The standard path's block is ``(onsets, available, slot_mask)``,
the onsets computed before the window (:func:`onset_front_end`). Every
window runs in its block's float type, float32 or float64.

"""

import numpy as np
import torch

from .kurtosis import kurtosis_cf_rows
from .migrate import DEFAULT_TILE, detect_reduce
from .rolling import padded_cumsum, trailing_window_sums
from .stalta import signal_transform


def _sta_lta_dynamic(signal, nsta, nlta, position):
    """
    Batched STA/LTA with per-row window lengths (rows may belong to
    different phases); ``position`` is "classic" or "centred". Semantics
    match ops.stalta; the running sums are added in the reference's order
    on every device (FE1's contract).

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
        sta = trailing_window_sums(signal, nsta, reference_order=True)
        lta = trailing_window_sums(signal, nlta, reference_order=True)
        ratio = torch.where(
            lta < tiny, 1.0, sta / torch.clamp(lta, min=tiny) * frac
        )
        return torch.where(idx >= (nlta_col - 1), ratio, 1.0)

    # centred: lta trails, sta leads
    padded = padded_cumsum(signal, reference_order=True)
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

    return _rms_combine(onsets_rows.reshape(n_slots, c_max, t), chan_mask,
                        slot_mask, min_onset_value)


def _rms_combine(onsets_c, chan_mask, slot_mask, min_onset_value):
    """RMS combine of the live channels [n_slots, C_max, T] per slot,
    clip, and dead slots set to ones (log-domain zero; excluded via
    slot_mask). Returns (combined [n_slots, T], available)."""

    weights = chan_mask[..., None]
    n_live = torch.clamp(chan_mask.sum(dim=1), min=1.0)[:, None]
    combined = torch.sqrt((onsets_c**2 * weights).sum(dim=1) / n_live)
    combined = torch.clamp(combined, min=min_onset_value)
    combined = torch.where(slot_mask[:, None] == 1.0, combined, 1.0)
    return combined, slot_mask.sum()


def fused_kurtosis_onsets(
    channels, chan_mask, slot_mask, nkurt, nsmooth, taper_pad,
    min_onset_value,
):
    """
    Onset front end of the fused kurtosis window: per-row kurtosis
    characteristic function (per-slot window lengths) -> the tapered
    edges set to the baseline 1 (the first ``taper_pad + nkurt - 1`` and
    the last ``max(taper_pad, 1)`` samples, as
    ``KurtosisOnset._combine``) -> RMS channel combine -> clip. Returns
    (combined [n_slots, T], available 0-dim tensor).

    """

    n_slots, c_max, t = channels.shape
    nkurt_rows = torch.repeat_interleave(nkurt, c_max)
    cf = kurtosis_cf_rows(channels.reshape(n_slots * c_max, t), nkurt_rows,
                          nsmooth)
    idx = torch.arange(t, device=channels.device)[None, :]
    lo = (taper_pad + nkurt_rows - 1)[:, None]
    edge = (idx < lo) | (idx >= t - max(taper_pad, 1))
    cf = torch.where(edge, 1.0, cf)
    return _rms_combine(cf.reshape(n_slots, c_max, t), chan_mask, slot_mask,
                        min_onset_value)


def stalta_front_end(position, transform, min_onset_value):
    """The STA/LTA front end of these settings, as a function of a block
    ``(channels, chan_mask, slot_mask, nsta, nlta)``: FE1 v2
    (``ops.cuda_front_end.fused_onsets_cuda_v2``) on a block on the card,
    the plain :func:`fused_onsets` on a CPU block."""

    def front_end(channels, chan_mask, slot_mask, nsta, nlta):
        if channels.is_cuda:
            from .cuda_front_end import fused_onsets_cuda_v2

            return fused_onsets_cuda_v2(channels, chan_mask, slot_mask,
                                        nsta, nlta, position, transform,
                                        min_onset_value)
        return fused_onsets(channels, chan_mask, slot_mask, nsta, nlta,
                            position, transform, min_onset_value)
    return front_end


def kurtosis_front_end(nsmooth, taper_pad, min_onset_value):
    """The kurtosis front end of these settings
    (``KurtosisOnset.fused_static_args``), as a function of a block
    ``(channels, chan_mask, slot_mask, nkurt)``: FE2 v2
    (``ops.cuda_front_end.fused_kurtosis_onsets_cuda_v2``) on a block on
    the card, the plain :func:`fused_kurtosis_onsets` on a CPU block."""

    def front_end(channels, chan_mask, slot_mask, nkurt):
        if channels.is_cuda:
            from .cuda_front_end import fused_kurtosis_onsets_cuda_v2

            return fused_kurtosis_onsets_cuda_v2(
                channels, chan_mask, slot_mask, nkurt, nsmooth, taper_pad,
                min_onset_value)
        return fused_kurtosis_onsets(channels, chan_mask, slot_mask, nkurt,
                                     nsmooth, taper_pad, min_onset_value)
    return front_end


def onset_front_end():
    """The front end of the standard detect path, as a function of a
    block ``(onsets, available, slot_mask)``: the onsets [n_slots, T]
    already computed by the onset's ``calculate_onsets`` and scattered
    into the canonical slot layout (``QuakeScan._device_inputs``), the
    count of live slots (a one-element array) and the slot mask. Returns
    (onsets, available): the window's device work is the migration
    alone."""

    def front_end(onsets, available, slot_mask):
        return onsets, available
    return front_end


def detect_window(front_end, block, traveltimes, fsmp, nsamples,
                  n_nodes_real=None, tile=DEFAULT_TILE):
    """
    One detect window in plain PyTorch: ``front_end`` on the block (its
    third array is the slot mask), then the flat-order migration of
    ops.migrate. Returns (max_coa, max_norm_coa, max_idx), each [S].

    """

    combined, available = front_end(*block)
    n_real = traveltimes.shape[0] if n_nodes_real is None else n_nodes_real
    max_coa, max_idx, coa_sum = detect_reduce(
        combined, traveltimes, block[2], available, fsmp, nsamples,
        n_real, tile,
    )
    return max_coa, max_coa * n_real / coa_sum, max_idx


def detect_window_cuda(front_end, block, detector, n_nodes_real):
    """
    One detect window with the migrate-and-reduce of ``detector`` (an
    ops.cuda_migrate.CudaDetect, CudaDetectVPU or CudaDetectGlobal, which
    carries fsmp and nsamples) in place of the flat-order reduction. Same
    contract as :func:`detect_window`; argmax ties follow brick order on
    the staged kernels' routes and the first flat index on K3's.

    """

    combined, available = front_end(*block)
    max_coa, max_idx, coa_sum = detector.reduce(combined, block[2],
                                                available)
    return max_coa, max_coa * n_nodes_real / coa_sum, max_idx


def detect_window_fused(
    channels, chan_mask, slot_mask, nsta, nlta, traveltimes,
    position, transform, min_onset_value, fsmp, nsamples,
    n_nodes_real=None, tile=DEFAULT_TILE,
):
    """
    One STA/LTA detect window in plain PyTorch (the plain front end
    :func:`fused_onsets` on any device), with the flat-order migration of
    ops.migrate. Returns (max_coa, max_norm_coa, max_idx), each [S].

    """

    return detect_window(
        lambda *block: fused_onsets(*block, position, transform,
                                    min_onset_value),
        (channels, chan_mask, slot_mask, nsta, nlta), traveltimes, fsmp,
        nsamples, n_nodes_real, tile,
    )


def detect_window_fused_kurtosis(
    channels, chan_mask, slot_mask, nkurt, traveltimes, nsmooth, taper_pad,
    min_onset_value, fsmp, nsamples, n_nodes_real=None, tile=DEFAULT_TILE,
):
    """
    One kurtosis detect window in plain PyTorch (the JAX
    ``detect_window_fused_kurtosis``; the plain front end
    :func:`fused_kurtosis_onsets` on any device), with the flat-order
    migration of ops.migrate. Returns (max_coa, max_norm_coa, max_idx),
    each [S].

    """

    return detect_window(
        lambda *block: fused_kurtosis_onsets(*block, nsmooth, taper_pad,
                                             min_onset_value),
        (channels, chan_mask, slot_mask, nkurt), traveltimes, fsmp, nsamples,
        n_nodes_real, tile,
    )


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
