# -*- coding: utf-8 -*-
"""
The stride-16 table detect kernels on the tensor cores: v1
(``csrc/migrate_detect_x16g.cu``, ``mma.sync``) and v2
(``csrc/migrate_detect_x16g_v2.cu``, ``wgmma`` with the one-hot A in
registers and each k-step's Hankel B built once per block in a ring).
Their plan on the card, the hi/lo tables built on the card, the wrappers
with their shared-memory sizing and launch counts, and occupancy.

Counterparts of the TPU experiment kernel ``_x16g_kernel``
(``experiments/exp_x16g.py``); both compute the function of the plain
version :func:`~quakemigrate_torch.ops.x16g.detect_reduce_x16g_reference`
from the same inputs. v1's forms are those of the TPU ``fuse``:
``fuse=False`` expands each onset's Hankel block in shared memory,
``fuse=True`` reads the product's B fragments from the staged rows. The
TPU ``aligned`` pads K to its sublane tile, which the card's k16 steps
already are: both values launch the same kernel. v2 has one form.

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

# v2's geometry (csrc/migrate_detect_x16g_v2.cu): samples a block (QW_N),
# bf16 a staged row (QW_PITCH), ring stages (QW_STAGES), the largest tile
# (QW_TILE_MAX) and its multiple (one m64 tile of wgmma)
V2_SBLK = 64
V2_PITCH = 80
V2_STAGES = 8
V2_TILE_MAX = 512
V2_TILE_STEP = 64
V2_MAX_ONSETS = 255  # a_off is a kernel parameter of this many + 1 ints
# v2's ablations, in the order of its QwAblate
V2_ABLATIONS = ("full", "nomain", "noreduce")

# Launches of each kernel, counted by its wrapper where it launches.
launches = {"migrate_detect_x16g": 0, "migrate_detect_x16g_v2": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


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


def x16g_v2_smem(a_sum):
    """
    Shared-memory bytes of one v2 block (csrc ``qw_layout``): the ring of
    ``V2_STAGES`` stages of two 2 KB Hankel tiles, the threads' fine16
    buffers (two onsets x 8 nodes x 256 threads, int32), the staged rows
    of hi and lo (``2 a_sum`` rows of 160 bytes), the cross-warp reduction
    (3 x 8 warps x 64 samples x 4 bytes), a full and an empty barrier a
    stage, and 1024 bytes for aligning the base. Raises when a block may
    not have that much.

    """

    ring = V2_STAGES * 2 * 16 * V2_SBLK * 2
    fine = 2 * 256 * 8 * 4
    red_off = round_up(ring + fine + 2 * a_sum * V2_PITCH * 2, 16)
    smem = red_off + 3 * 8 * V2_SBLK * 4 + 2 * V2_STAGES * 8 + 1024
    check_smem(smem, f"{2 * a_sum} staged rows and a ring of {V2_STAGES} "
               "Hankel stages")
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


def x16g_v2_blocks_per_sm(a_sum, device):
    """Resident blocks per SM of v2's full kernel at a plan, from the
    occupancy API."""

    return blocks_per_sm("qm_migrate_detect_x16g_v2_blocks_per_sm", device,
                         a_sum)


def _check_inputs(p, hi, lo, want, inv_available, nsamples, ablate,
                  ablations):
    """The checks both wrappers share: a known ablation, CUDA tensors of
    the kernels' types, shapes and alignment. Returns (n_onsets, n_tiles,
    tile, m_pad, width)."""

    if ablate not in ablations:
        raise ValueError(f"unknown ablation {ablate!r}; one of {ablations}")
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
    if m_pad < p.a_sum:
        raise ValueError(f"{m_pad} target rows for {p.a_sum} coarse rows")
    return n_onsets, n_tiles, tile, m_pad, width


def migrate_detect_x16g_cuda(p, hi, lo, want, inv_available, nsamples,
                             fuse=False, ablate="full"):
    """
    Launch v1 on tensors on the card: ``p`` the plan of
    :func:`plan_on_device`, ``hi``, ``lo`` bf16 tables ``[O * a_pad,
    width]`` and ``want`` int32 ``[n_tiles, m_pad, 1]`` of
    :func:`build_inputs`, ``inv_available`` f32 ``[1]``. ``ablate`` is one
    of :data:`x16g.ABLATIONS`. Returns (tmax f32, targ int32, tsum f32),
    each [n_tiles, nsamples], asynchronously on the current stream.

    """

    n_onsets, n_tiles, tile, m_pad, width = _check_inputs(
        p, hi, lo, want, inv_available, nsamples, ablate, x16g.ABLATIONS)
    if tile % NODES:
        raise ValueError(f"tile ({tile}) must be a multiple of {NODES}")
    x16g_smem(n_onsets, p.a_sum, p.a_max, fuse)
    outs = empty_outputs(n_tiles, nsamples, hi.device)
    launch_kernel(
        "qm_migrate_detect_x16g", hi.device, hi.data_ptr(), lo.data_ptr(),
        width, want.data_ptr(), m_pad, p.a_off.data_ptr(),
        p.fine16.data_ptr(), p.valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, nsamples,
        p.a_sum, p.a_max, int(bool(fuse)), x16g.ABLATIONS.index(ablate),
    )
    launches["migrate_detect_x16g"] += 1
    return outs


def migrate_detect_x16g_v2_cuda(p, hi, lo, want, inv_available, nsamples,
                                ablate="full"):
    """
    Launch v2 on tensors on the card, with v1's inputs (see
    :func:`migrate_detect_x16g_cuda`); the tile a multiple of 64 up to
    512. ``ablate`` is one of :data:`V2_ABLATIONS`. Returns (tmax f32,
    targ int32, tsum f32), each [n_tiles, nsamples], asynchronously on the
    current stream.

    """

    n_onsets, n_tiles, tile, m_pad, width = _check_inputs(
        p, hi, lo, want, inv_available, nsamples, ablate, V2_ABLATIONS)
    if tile % V2_TILE_STEP or tile > V2_TILE_MAX:
        raise ValueError(f"tile ({tile}) must be a multiple of "
                         f"{V2_TILE_STEP} up to {V2_TILE_MAX}")
    if n_onsets > V2_MAX_ONSETS:
        raise ValueError(f"{n_onsets} onsets, over v2's {V2_MAX_ONSETS}")
    x16g_v2_smem(p.a_sum)
    a_off = x16g.a_offsets(p.r_spans16)  # host copy: a kernel parameter
    outs = empty_outputs(n_tiles, nsamples, hi.device)
    launch_kernel(
        "qm_migrate_detect_x16g_v2", hi.device, hi.data_ptr(), lo.data_ptr(),
        width, want.data_ptr(), m_pad, a_off.ctypes.data,
        p.fine16.data_ptr(), p.valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, nsamples,
        p.a_sum, V2_ABLATIONS.index(ablate),
    )
    launches["migrate_detect_x16g_v2"] += 1
    return outs
