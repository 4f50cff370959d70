# -*- coding: utf-8 -*-
"""
Staging and streaming probes of the detect kernel on the card: their
wrappers, geometry and plain PyTorch versions.

Counterpart of the TPU experiment ``experiments/exp_dma_probe.py`` and
its two kernels:

- ``_probe_kernel`` -> :func:`migrate_detect_probe_cuda`, the pipelined
  kernel (``csrc/migrate_detect_pipelined.cu``) at 2 stages with its step
  loop unrolled to static slots: mode ``static2`` keeps the production
  contract (plain version
  :func:`~quakemigrate_torch.ops.cuda_migrate.detect_reduce_plan_reference`);
  mode ``packed`` stages one contiguous run per step from a zero table,
  timing only, whose contract is the closed form :func:`packed_reference`;
  and their redesign on E1c v2's TMA ring, E4b v2
  (``csrc/migrate_detect_probe_v2.cu``,
  :func:`migrate_detect_probe_v2_cuda`), through E1c v2's tables
  (``cuda_breakdown.pipelined_v2_tables``): ``static2`` with every slot,
  barrier and phase parity constant, plain version
  :func:`detect_reduce_probe_v2_reference`; ``packed`` with one bulk copy
  a step from :func:`packed_v2_zeros`;
- ``_stream_kernel`` -> :func:`stream_probe_cuda`
  (``csrc/stream_probe.cu``): a bf16 ``[n_chunks, rows, 2048]`` source
  streamed ``n_total`` chunks long through shared memory, chunk ``t mod
  n_chunks`` at step t; plain version :func:`stream_probe_reference`.

Every wrapper takes CUDA tensors only and counts its launches in
:data:`launches`.

"""

from types import SimpleNamespace

import torch

from . import cuda_breakdown as cb
from .cuda_breakdown import check_pipelined_args
from .cuda_migrate import (
    SBLK,
    blocks_per_sm,
    check_smem,
    detect_reduce_plan_reference,
    empty_outputs,
    launch_kernel,
)

PROBE_MODES = ("static2", "packed")

# The streamed table: rows of ROW_SAMPLES bf16 (the TPU probe's sblk),
# cut into pieces of PIECE_ROWS rows (csrc/stream_probe.cu: QS_*).
ROW_SAMPLES = 2048
ROW_BYTES = 2 * ROW_SAMPLES
PIECE_ROWS = 8
STREAM_ROWS = (64, 256, 1024)
SOURCE_BYTES = 2**29         # 512 MiB, as on the TPU
STREAM_BYTES = 16 * 2**30    # 16 GiB streamed, as on the TPU
OUT_ROWS, OUT_LANES = 8, 128

# Launches of each kernel, counted by its wrapper where it launches.
launches = {"migrate_detect_probe": 0, "migrate_detect_probe_v2": 0,
            "stream_probe": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


def packed_zeros(nsamples, slot_floats, device):
    """The zero table the ``packed`` probe stages from: one slot of
    ``slot_floats`` floats per sample block."""

    return torch.zeros(-(-nsamples // SBLK) * slot_floats,
                       dtype=torch.float32, device=device)


def packed_reference(valid, nsamples):
    """
    Closed form of the ``packed`` probe: with every staged window zero,
    ``coa = exp(0) * valid = valid``, so per tile ``tmax`` is the largest
    valid, ``targ`` the first node attaining it and ``tsum`` the sum of
    valid, at every sample. Returns (tmax f32, targ int32, tsum f32), each
    [n_tiles, nsamples].

    """

    shape = (valid.shape[0], nsamples)
    tmax = valid.amax(dim=1)
    targ = torch.argmax(valid, dim=1).to(torch.int32)
    tsum = valid.sum(dim=1)
    return tuple(x[:, None].expand(shape).contiguous()
                 for x in (tmax, targ, tsum))


def detect_reduce_probe_reference(onsets_log, base, fine, valid,
                                  inv_available, fsmp, nsamples, mode):
    """
    Plain PyTorch version of the staging probe ``mode``: ``static2`` keeps
    the production contract (the plan reference); ``packed`` stages zeros
    whatever the onsets, so its contract is :func:`packed_reference`.
    Returns (tmax f32, targ int32, tsum f32), each [n_tiles, nsamples].

    """

    if mode not in PROBE_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {PROBE_MODES}")
    if mode == "packed":
        return packed_reference(valid, nsamples)
    return detect_reduce_plan_reference(onsets_log, base, fine, valid,
                                        inv_available, fsmp, nsamples)


def migrate_detect_probe_cuda(onsets_log, base, fine, valid, inv_available,
                              fsmp, nsamples, span_off, slot_floats, mode,
                              zeros=None):
    """
    Launch the staging probe ``mode`` (one of :data:`PROBE_MODES`) on
    tensors on the card: the pipelined kernel at 2 stages, slots laid out
    by ``span_off`` (int32 [O + 1] on the card, ``slot_floats`` its last
    entry), its step loop unrolled to static slots, as many blocks per SM
    as fit. ``packed`` stages
    from ``zeros`` (:func:`packed_zeros`) and needs ``slot_floats`` a
    multiple of 4. Returns (tmax f32, targ int32, tsum f32), each
    [n_tiles, nsamples], asynchronously on the current stream.

    """

    if mode not in PROBE_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {PROBE_MODES}")
    n_onsets, t_len, n_tiles, tile = check_pipelined_args(
        onsets_log, base, fine, valid, inv_available, nsamples, span_off,
        slot_floats, 2,
    )
    packed = mode == "packed"
    if packed:
        need = -(-nsamples // SBLK) * slot_floats
        if slot_floats % 4:
            raise ValueError(
                f"packed staging needs slot_floats ({slot_floats}) a "
                "multiple of 4"
            )
        if (zeros is None or zeros.device != onsets_log.device
                or zeros.dtype != torch.float32 or not zeros.is_contiguous()
                or zeros.numel() < need or zeros.data_ptr() % 16):
            raise ValueError(
                f"packed staging needs a contiguous, 16-byte aligned float32 "
                f"zero table of at least {need} values on {onsets_log.device}"
            )
    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_probe", onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), span_off.data_ptr(),
        fine.data_ptr(), valid.data_ptr(), inv_available.data_ptr(),
        zeros.data_ptr() if packed else None,
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, fsmp,
        nsamples, slot_floats, int(packed),
    )
    launches["migrate_detect_probe"] += 1
    return outs


def packed_v2_zeros(nsamples, n_onsets, stride, device):
    """The zero table E4b v2's ``packed`` probe stages from: one slot of
    ``n_onsets * stride`` floats per sample block, 16-byte aligned."""

    return torch.zeros(-(-nsamples // SBLK) * n_onsets * stride,
                       dtype=torch.float32, device=device)


def detect_reduce_probe_v2_reference(onsets_log, base, valid, inv_available,
                                     fsmp, nsamples, tables, mode):
    """
    Plain PyTorch version of E4b v2's probe ``mode`` through E1c v2's
    ``tables``: ``static2`` gathers through the slab and window layout
    (``cuda_breakdown.pipelined_v2_reference``, K1's contract); ``packed``
    stages zeros whatever the onsets, so its contract is
    :func:`packed_reference`. Returns (tmax f32, targ int32, tsum f32),
    each [n_tiles, nsamples].

    """

    if mode not in PROBE_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {PROBE_MODES}")
    if mode == "packed":
        return packed_reference(valid, nsamples)
    return cb.pipelined_v2_reference(onsets_log, base, valid, inv_available,
                                     fsmp, nsamples, tables)


def migrate_detect_probe_v2_cuda(onsets_log, base, valid, inv_available,
                                 fsmp, nsamples, tables, mode, zeros=None):
    """
    Launch E4b v2's probe ``mode`` (one of :data:`PROBE_MODES`) on tensors
    on the card: E1c v2's persistent, tile-major 2-slot TMA ring through
    the ``tables`` of ``cuda_breakdown.pipelined_v2_tables`` (built for
    this ``fsmp``), its step loop unrolled so that every slot, barrier and
    phase parity is a constant. ``packed`` stages each step with one bulk
    copy from ``zeros`` (:func:`packed_v2_zeros`). Returns (tmax f32, targ
    int32, tsum f32), each [n_tiles, nsamples], asynchronously on the
    current stream.

    """

    if mode not in PROBE_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {PROBE_MODES}")
    cb._check_tables_fsmp(tables, fsmp)
    n_tiles, tile = valid.shape
    n_onsets = onsets_log.shape[0]
    n_onsets, t_len, n_tiles, tile = cb._check_slab_kernel_args(
        onsets_log, valid, inv_available, nsamples, {
            "base": (base, torch.int32, (n_tiles, n_onsets)),
            "slab": (tables.slab, torch.uint16,
                     (n_tiles, tile, -(-n_onsets // 8) * 8)),
        })
    stride, box = tables.stride, tables.box
    if (stride % cb.TMA_ALIGN or not SBLK < box <= min(stride, 256)
            or box % 4):
        raise ValueError(f"bad window layout: stride {stride}, box {box}")
    packed = mode == "packed"
    if packed:
        need = -(-nsamples // SBLK) * n_onsets * stride
        if (zeros is None or zeros.device != onsets_log.device
                or zeros.dtype != torch.float32 or not zeros.is_contiguous()
                or zeros.numel() < need or zeros.data_ptr() % 16):
            raise ValueError(
                f"packed staging needs a contiguous, 16-byte aligned float32 "
                f"zero table of at least {need} values on {onsets_log.device}"
            )
    check_smem(cb.pipelined_v2_smem(n_onsets, tile, stride, 2),
               f"2 slots of {n_onsets} x {stride} floats")
    rows, pitch = cb._row_pitch(onsets_log)
    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_probe_v2", onsets_log.device,
        rows.data_ptr(), t_len, pitch, base.data_ptr(),
        tables.slab.data_ptr(), valid.data_ptr(), inv_available.data_ptr(),
        zeros.data_ptr() if packed else None,
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, fsmp,
        nsamples, stride, box, int(packed),
    )
    launches["migrate_detect_probe_v2"] += 1
    return outs


def probe_v2_blocks_per_sm(n_onsets, tile, stride, device):
    """Resident blocks per SM of E4b v2 (static2) at a window layout."""

    return blocks_per_sm("qm_migrate_detect_probe_v2_blocks_per_sm", device,
                         n_onsets, tile, stride)


def stream_geometry(rows, source_bytes=SOURCE_BYTES, stream_bytes=STREAM_BYTES):
    """
    Geometry of the streaming probe for a table of ``rows`` rows a chunk,
    as the TPU probe sizes it (``exp_dma_probe.py:94-99``): ``n_chunks``
    chunks fill ``source_bytes``, ``n_total`` chunks make up
    ``stream_bytes``; the kernel moves each chunk in ``pieces_per_chunk``
    pieces of ``PIECE_ROWS`` rows through two slots of shared memory
    (``smem`` bytes).

    """

    if rows < PIECE_ROWS or rows % PIECE_ROWS:
        raise ValueError(f"rows ({rows}) must be a multiple of {PIECE_ROWS}")
    chunk_bytes = rows * ROW_BYTES
    n_chunks = source_bytes // chunk_bytes
    n_total = stream_bytes // chunk_bytes
    if n_chunks < 1 or n_total < 1:
        raise ValueError(
            f"a chunk of {chunk_bytes} bytes does not fit {source_bytes} "
            f"bytes of source and {stream_bytes} streamed"
        )
    piece_bytes = PIECE_ROWS * ROW_BYTES
    return SimpleNamespace(
        rows=rows, chunk_bytes=chunk_bytes, n_chunks=n_chunks,
        n_total=n_total, pieces_per_chunk=rows // PIECE_ROWS,
        n_pieces=n_total * (rows // PIECE_ROWS), piece_bytes=piece_bytes,
        smem=2 * piece_bytes, stream_bytes=n_total * chunk_bytes,
    )


def stream_chunk(step, n_chunks):
    """The source chunk of stream step ``step``: ``step mod n_chunks``,
    written as the TPU kernel computes it."""

    return step - (step // n_chunks) * n_chunks


def stream_source(geometry, device, seed=0):
    """A seeded random bf16 source [n_chunks, rows, ROW_SAMPLES]."""

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    src = torch.empty((geometry.n_chunks, geometry.rows, ROW_SAMPLES),
                      dtype=torch.bfloat16, device=device)
    return src.normal_(generator=gen)


def stream_probe_reference(src, n_total):
    """Plain version of the streaming probe: the last step's chunk, rows
    0-7, lanes 0-127, as f32 [8, 128]."""

    chunk = stream_chunk(n_total - 1, src.shape[0])
    return src[chunk, :OUT_ROWS, :OUT_LANES].float()


def stream_probe_cuda(src, n_total):
    """
    Launch the streaming probe on a bf16 ``src`` [n_chunks, rows,
    ROW_SAMPLES] on the card: ``n_total`` chunks streamed through shared
    memory by a persistent grid of as many blocks per SM as fit. Returns
    f32 [8, 128], asynchronously on the current stream.

    """

    if src.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {src.device}")
    if (src.dtype != torch.bfloat16 or src.dim() != 3
            or src.shape[2] != ROW_SAMPLES or not src.is_contiguous()):
        raise ValueError(
            f"src must be a contiguous bf16 [n_chunks, rows, {ROW_SAMPLES}] "
            f"tensor, got {src.dim()}-D {src.dtype} {tuple(src.shape)}"
        )
    n_chunks, rows, _ = src.shape
    if rows < PIECE_ROWS or rows % PIECE_ROWS or n_total < 1:
        raise ValueError(
            f"rows ({rows}) must be a multiple of {PIECE_ROWS}, n_total "
            f"({n_total}) positive"
        )
    out = torch.empty((OUT_ROWS, OUT_LANES), dtype=torch.float32,
                      device=src.device)
    launch_kernel("qm_stream_probe", src.device, src.data_ptr(), n_chunks,
                  rows, n_total, out.data_ptr())
    launches["stream_probe"] += 1
    return out
