# -*- coding: utf-8 -*-
"""
The shifted-copy detect kernel on the card (``csrc/migrate_detect_x16.cu``):
its wrapper, shared-memory sizing and occupancy.

Counterpart of the TPU experiment kernel ``_x16_kernel``
(``experiments/exp_x16.py``): each onset's staged window is kept in four
copies shifted by 0..3 floats, so every lane reads four consecutive
samples of a node with one aligned 16-byte load. K1's
contract, exactly; its plain version is
:func:`~quakemigrate_torch.ops.x16.detect_reduce_stride_reference`. The
two layouts of the copies are those of the TPU operand: ``x16a``
(copy-major) and ``x16b`` (onset-major).

"""

from quakemigrate_torch.util import round_up
from .cuda_migrate import (
    NWARPS,
    SBLK,
    _check_onset_length,
    blocks_per_sm,
    check_kernel_args,
    check_smem,
    empty_outputs,
    launch_kernel,
)

LAYOUTS = ("x16a", "x16b")

# Launches of the kernel, counted by its wrapper where it launches.
launches = {"migrate_detect_x16": 0}


def reset_launches():
    launches["migrate_detect_x16"] = 0


def x16_window_floats(r_span):
    """Floats of one shifted copy of a staged window: ``r_span + SBLK``
    rounded up to a multiple of 4, so every copy starts 16-byte aligned."""

    return round_up(r_span + SBLK, 4)


def x16_smem(n_onsets, r_span):
    """Shared-memory bytes of one block, the same in both layouts: four
    copies of every onset's window (the cross-warp reduction reuses
    them). Raises when a block may not have that much."""

    wp = x16_window_floats(r_span)
    smem = 4 * max(4 * n_onsets * wp, 3 * NWARPS * SBLK)
    check_smem(smem, f"four shifted copies of {n_onsets} windows of {wp} "
                     "floats")
    return smem


def x16_blocks_per_sm(n_onsets, r_span, layout, device):
    """Resident blocks per SM of the layout's kernel at a plan, from the
    occupancy API."""

    return blocks_per_sm("qm_migrate_detect_x16_blocks_per_sm", device,
                         n_onsets, r_span, LAYOUTS.index(layout))


def migrate_detect_x16_cuda(onsets_log, base, fine, valid, inv_available,
                            fsmp, nsamples, r_span, max_shift, layout="x16a"):
    """
    Launch the shifted-copy kernel in ``layout`` (one of :data:`LAYOUTS`)
    on tensors on the card. ``max_shift`` is the plan's largest traveltime
    (``DetectPlan.max_shift``): the onset block must hold ``fsmp +
    nsamples + max_shift`` samples. Returns (tmax f32, targ int32, tsum
    f32), each [n_tiles, nsamples], asynchronously on the current stream.

    """

    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine, valid, inv_available
    )
    if tile % NWARPS:
        raise ValueError(f"tile ({tile}) must be a multiple of {NWARPS}")
    if nsamples < 1 or r_span < 1:
        raise ValueError(f"bad geometry: nsamples {nsamples}, r_span {r_span}")
    _check_onset_length(onsets_log, fsmp, nsamples, max_shift)
    x16_smem(n_onsets, r_span)
    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_x16", onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), fine.data_ptr(),
        valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, fsmp,
        nsamples, r_span, LAYOUTS.index(layout),
    )
    launches["migrate_detect_x16"] += 1
    return outs
