# -*- coding: utf-8 -*-
"""
The stride-16 table detect kernel on the tensor cores
(``csrc/migrate_detect_x16g.cu``): its plan on the card, the hi/lo tables
built on the card, the wrapper with its shared-memory sizing and launch
count, and occupancy.

Counterpart of the TPU experiment kernel ``_x16g_kernel``
(``experiments/exp_x16g.py``); its plain version is
:func:`~quakemigrate_torch.ops.x16g.detect_reduce_x16g_reference`. The
forms are those of the TPU ``fuse``: ``fuse=False`` expands each onset's
Hankel block in shared memory, ``fuse=True`` reads the product's B
fragments from the staged rows. The TPU ``aligned`` pads K to its sublane
tile, which the card's k16 steps already are: both values launch the same
kernel.

"""

from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch.util import round_up
from . import x16g
from .cuda_migrate import (
    NWARPS,
    SBLK,
    blocks_per_sm,
    check_smem,
    empty_outputs,
    launch_kernel,
)

G_PITCH = 144    # bf16 a staged row (csrc: QG_PITCH)
NODES = 16       # nodes a warp owns a pass (csrc: QG_NODES)

# Launches of the kernel, counted by its wrapper where it launches.
launches = {"migrate_detect_x16g": 0}


def reset_launches():
    launches["migrate_detect_x16g"] = 0


def x16g_smem(n_onsets, a_sum, a_max, fuse):
    """
    Shared-memory bytes of one block (csrc ``qg_layout``): the staged rows
    of hi and lo (``2 a_sum`` rows of 288 bytes), in two copies for
    ``fuse``, or two double buffers of the largest onset's Hankel block
    (``16 a_max`` rows of 128 bf16, hi and lo); at least the cross-warp
    reduction; then the ``n_onsets + 1`` row offsets. Raises when a block
    may not have that much.

    """

    g_bytes = 2 * a_sum * G_PITCH * 2
    if fuse:
        end = round_up(g_bytes, 128) + 64 + g_bytes
    else:
        end = round_up(g_bytes, 128) + 4 * 16 * a_max * SBLK * 2
    end = max(end, 3 * NWARPS * SBLK * 4)
    smem = round_up(end, 16) + 4 * (n_onsets + 1)
    what = ("in two copies" if fuse
            else f"and Hankel blocks of {16 * a_max} rows")
    check_smem(smem, f"{2 * a_sum} staged rows {what}")
    return smem


def plan_on_device(plan, device):
    """The 16-aligned plan of a ``DetectPlan`` on ``device``: a namespace
    with base16, fine16 and valid tensors, r_spans16, a_counts, a_sum,
    a_max and the row offsets ``a_off`` (int32 [O + 1])."""

    base16, fine16, r_spans16 = x16g.align_plan16(plan)
    counts = x16g.a_counts(r_spans16)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SimpleNamespace(
        base16=base16, r_spans16=r_spans16, a_counts=counts,
        a_sum=sum(counts), a_max=max(counts), n_onsets=plan.n_onsets,
        base16_dev=put(base16), fine16=put(fine16), valid=put(plan.valid),
        a_off=put(x16g.a_offsets(r_spans16)), max_shift=plan.max_shift,
    )


def build_inputs(p, onsets_log, fsmp, nsamples):
    """The kernel's table inputs on the onsets' device: (hi, lo, want
    int32 [n_tiles, m_pad, 1], a_pad), the tables built with torch ops
    (:func:`x16g.x16g_tables`)."""

    hi, lo, a_pad = x16g.x16g_tables(onsets_log, fsmp, nsamples, p.r_spans16,
                                     p.max_shift)
    want = torch.from_numpy(x16g.coarse_targets(p.base16, p.r_spans16,
                                                a_pad)).to(onsets_log.device)
    return hi, lo, want, a_pad


def x16g_blocks_per_sm(n_onsets, a_sum, a_max, fuse, device):
    """Resident blocks per SM of the full kernel in the form ``fuse`` at a
    plan, from the occupancy API."""

    return blocks_per_sm("qm_migrate_detect_x16g_blocks_per_sm", device,
                         n_onsets, a_sum, a_max, int(bool(fuse)))


def migrate_detect_x16g_cuda(p, hi, lo, want, inv_available, nsamples,
                             fuse=False, ablate="full"):
    """
    Launch the kernel on tensors on the card: ``p`` the plan of
    :func:`plan_on_device`, ``hi``, ``lo`` bf16 tables ``[O * a_pad,
    width]`` and ``want`` int32 ``[n_tiles, m_pad, 1]`` of
    :func:`build_inputs`, ``inv_available`` f32 ``[1]``. ``ablate`` is one
    of :data:`x16g.ABLATIONS`. Returns (tmax f32, targ int32, tsum f32),
    each [n_tiles, nsamples], asynchronously on the current stream.

    """

    if ablate not in x16g.ABLATIONS:
        raise ValueError(f"unknown ablation {ablate!r}; one of "
                         f"{x16g.ABLATIONS}")
    device = hi.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    n_tiles, n_onsets, tile = p.fine16.shape
    m_pad = want.shape[1]
    expected = (
        ("hi", hi, torch.bfloat16, hi.shape),
        ("lo", lo, torch.bfloat16, hi.shape),
        ("want", want, torch.int32, (n_tiles, m_pad, 1)),
        ("a_off", p.a_off, torch.int32, (n_onsets + 1,)),
        ("fine16", p.fine16, torch.int32, (n_tiles, n_onsets, tile)),
        ("valid", p.valid, torch.float32, (n_tiles, tile)),
        ("inv_available", inv_available, torch.float32, (1,)),
    )
    for name, x, dtype, shape in expected:
        if (x.device != device or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape "
                f"{tuple(shape)} on {device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
            )
    width = hi.shape[1]
    if width % 8 or width < x16g.table_width(nsamples):
        raise ValueError(f"tables of width {width} do not cover {nsamples} "
                         "samples")
    if hi.data_ptr() % 16 or lo.data_ptr() % 16:
        raise ValueError("the tables must be 16-byte aligned")
    if tile % NODES:
        raise ValueError(f"tile ({tile}) must be a multiple of {NODES}")
    if m_pad < p.a_sum:
        raise ValueError(f"{m_pad} target rows for {p.a_sum} coarse rows")
    x16g_smem(n_onsets, p.a_sum, p.a_max, fuse)
    outs = empty_outputs(n_tiles, nsamples, device)
    launch_kernel(
        "qm_migrate_detect_x16g", device, hi.data_ptr(), lo.data_ptr(), width,
        want.data_ptr(), m_pad, p.a_off.data_ptr(), p.fine16.data_ptr(),
        p.valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, nsamples,
        p.a_sum, p.a_max, int(bool(fuse)), x16g.ABLATIONS.index(ablate),
    )
    launches["migrate_detect_x16g"] += 1
    return outs
