# -*- coding: utf-8 -*-
"""
Fused migrate-and-reduce on the GPU: the node-tile plan, the wrappers of
the CUDA kernels ``csrc/migrate_detect.cu`` (K1),
``csrc/migrate_detect_v2.cu`` (K1 v2, the same contract redesigned for
the card's shared-memory pipe), ``csrc/migrate_detect_vpu.cu`` (K2) and
``csrc/migrate_detect_vpu_v2.cu`` (K2 v2, K2 on an mbarrier ring), their
plain PyTorch versions, and the cross-tile combine; and the wrapper of
``csrc/migrate_marginalise.cu`` (M1, locate's marginalisation on the same
plan) and ``csrc/migrate_marginalise_v2.cu`` (M1 v2, M1 on K1 v2's
tables), whose plain version is ``ops.migrate.migrate_marginalise``.

Counterpart of quakemigrate_tpu.ops.pallas_migrate: ``CudaDetect`` of
``PallasDetectMXU`` (kernel ``_mxu_detect_kernel``), ``CudaDetectVPU`` of
``PallasDetect`` (kernel ``_detect_kernel``). The flat node axis is reordered
into spatially compact bricks, so every node of a tile has a traveltime
close to the tile's minimum: per (tile, onset) a base shift, and per node
a small residual ``fine < r_span``. One shared-memory window of each
onset row then feeds every node of the tile.

Contract of the kernels, per node tile i and scan sample t:

    coa[n, t] = exp(sum_o L[o, fsmp + base[i, o] + fine[i, o, n] + t]
                    * inv_available) * valid[i, n]
    tmax[i, t] = max_n coa;  targ[i, t] = first n attaining it;
    tsum[i, t] = sum_n coa

with ``L`` the clipped, logged and masked onsets. ``combine_tiles`` then
takes the first tile attaining the max and maps the winner through
``perm`` to its flat node index. Ties therefore follow BRICK order (the
first node in the brick-permuted order), as the TPU kernels do; the
plain flat-order path (ops.migrate) breaks ties by flat index. Both pick
a node whose coalescence equals the maximum.

"""

import ctypes
from functools import cached_property
from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.util import round_up
from .migrate import _prepare_onsets

# Scan samples per thread block and warps per block; both are fixed in
# csrc/migrate_detect.cu (QM_SBLK, QM_NWARPS).
SBLK = 128
NWARPS = 8

# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448

# Geometry of the VPU-plan kernel (csrc/migrate_detect_vpu.cu: QV_SBLK,
# QV_WARPS): 32 samples and 16 warps a block, tile / 16 nodes a thread.
VPU_SBLK = 32
VPU_NWARPS = 16
VPU_TILES = (64, 128, 256, 512)

# K2 v2 (csrc/migrate_detect_vpu_v2.cu: QW_SBLK, QW_SHAPES, QW_GRP): 128
# samples a block, 4 a thread; per tile, the nodes a warp takes in one
# pass over the onsets; the onsets a ring stage holds; the ring depths
# it takes.
VPU_V2_SBLK = 128
VPU_V2_NPP = {64: 4, 128: 8, 256: 8, 512: 8}
VPU_V2_GROUP = 8
VPU_V2_STAGES = (2, 3, 4)

# Shared-memory alignment of a tiled TMA destination, in floats
# (csrc/tma_rows.cuh: QT_ALIGN_FLOATS), and TMA's largest box.
TMA_ALIGN = 32
TMA_MAX_BOX = 256

# Window samples a block of M1 takes (csrc/migrate_marginalise.cu:
# QM1_CHUNK, 32 lanes x QM1_SPL); a longer window is split into chunks.
M1_CHUNK = 256

# M1 v2 (csrc/migrate_marginalise_v2.cu): the window samples a block takes
# (QM2_CHUNK, K1 v2's sample block), and per samples a lane adds a node
# (1, 2 or 4: :func:`m1_v2_slots`) the nodes a warp gathers together
# (qm2_kernel's shapes, the fastest of a sweep on the H100 at the
# Icequake plan).
M1_V2_CHUNK = SBLK
M1_V2_NODES_IN_FLIGHT = {1: 4, 2: 4, 4: 2}

# Largest residual span of the int16 residual table ``DetectPlan.fine16``
FINE16_MAX_SPAN = np.iinfo(np.int16).max

# Launches of K1, K1 v2, K2, K2 v2, M1 and M1 v2, counted by their
# wrappers where they launch
launches = {"migrate_detect": 0, "migrate_detect_v2": 0,
            "migrate_detect_vpu": 0, "migrate_detect_vpu_v2": 0,
            "migrate_marginalise": 0, "migrate_marginalise_v2": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


def brick_permutation(node_count, brick_shape):
    """
    Permutation reordering the flat (C-order) node axis into spatially
    compact bricks. Returns (perm, n_padded): ``perm[new] = old`` flat
    index, with -1 marking padding nodes (bricks overhanging the grid).

    """

    node_count = np.asarray(node_count, dtype=int)
    brick_shape = np.asarray(brick_shape, dtype=int)
    n_bricks = -(-node_count // brick_shape)

    # Index grids over the padded volume, brick-major
    bi, bj, bk = [np.arange(n) for n in n_bricks]
    li, lj, lk = [np.arange(b) for b in brick_shape]

    # full index arrays: (Bi, Bj, Bk, bi, bj, bk)
    gi = (bi[:, None, None, None, None, None] * brick_shape[0]
          + li[None, None, None, :, None, None])
    gj = (bj[None, :, None, None, None, None] * brick_shape[1]
          + lj[None, None, None, None, :, None])
    gk = (bk[None, None, :, None, None, None] * brick_shape[2]
          + lk[None, None, None, None, None, :])
    gi, gj, gk = np.broadcast_arrays(gi, gj, gk)

    valid = (gi < node_count[0]) & (gj < node_count[1]) & (gk < node_count[2])
    flat = (gi * node_count[1] + gj) * node_count[2] + gk
    perm = np.where(valid, flat, -1).ravel()

    return perm.astype(np.int64), perm.size


class DetectPlan:
    """
    Host-side (numpy) plan of the detect kernel, built once per
    traveltime table:

    - ``perm``  int32 [n_tiles * tile]: brick order -> flat node index
      (0 for padding);
    - ``base``  int32 [n_tiles, O]: per-tile minimum traveltime over the
      tile's real nodes;
    - ``fine``  int32 [n_tiles, O, tile]: residual shift of each node
      (0 for padding, so padding never widens a span);
    - ``fine16`` int16 [n_tiles, tile, O]: the same residuals node-major,
      the table of K1 v2 (``csrc/migrate_detect_v2.cu``), built on first
      use, or None where ``r_span`` exceeds ``FINE16_MAX_SPAN`` (K1 v2
      then refuses the plan: :func:`v2_refusal`);
    - ``valid`` float32 [n_tiles, tile]: 1 for real nodes;
    - ``r_spans``: per onset, the largest residual + 1; ``r_span`` is
      their maximum, the width of a staged window beyond the sample block;
    - ``span_off`` int32 [O + 1]: K1 v2's window offsets
      (:func:`span_offsets`, per onset), ``win_floats = span_off[-1]``;
    - ``max_shift``: the largest traveltime, ``max(base + fine)``; a scan
      of ``nsamples`` reads onsets up to ``fsmp + nsamples + max_shift``;
    - ``bits`` and ``r_pow2 = 2**bits``: the shift-network depth and the
      power-of-two span of the TPU VPU kernel's plan (``PallasDetectPlan``),
      kept for parity only; no kernel here uses them.

    Traveltimes are clamped at 0.

    """

    def __init__(self, traveltimes, node_count, tile=256,
                 brick_shape=(8, 8, 4)):
        traveltimes = np.asarray(traveltimes)
        n_nodes, n_onsets = traveltimes.shape
        if int(np.prod(node_count)) != n_nodes:
            raise ValueError(
                f"node_count {tuple(node_count)} does not match the "
                f"{n_nodes} traveltime rows"
            )

        perm, n_padded = brick_permutation(node_count, brick_shape)
        n_padded = round_up(n_padded, tile)
        if perm.size < n_padded:
            perm = np.concatenate(
                [perm, np.full(n_padded - perm.size, -1, dtype=perm.dtype)]
            )

        tt_perm = np.zeros((n_padded, n_onsets), dtype=np.int32)
        live = perm >= 0
        tt_perm[live] = np.maximum(traveltimes[perm[live]], 0)

        n_tiles = n_padded // tile
        tt_tiles = tt_perm.reshape(n_tiles, tile, n_onsets)
        live_tiles = live.reshape(n_tiles, tile)
        masked = np.where(
            live_tiles[..., None], tt_tiles, np.iinfo(np.int32).max
        )
        base = masked.min(axis=1)
        base = np.where(base == np.iinfo(np.int32).max, 0, base)
        fine = np.where(live_tiles[..., None], tt_tiles - base[:, None, :], 0)

        self.tile = tile
        self.n_tiles = n_tiles
        self.n_onsets = n_onsets
        self.n_nodes = n_nodes
        self.perm = np.where(live, perm, 0).astype(np.int32)
        self.base = base.astype(np.int32)
        self.fine = np.ascontiguousarray(fine.transpose(0, 2, 1), np.int32)
        self.valid = live_tiles.astype(np.float32)
        self.r_spans = tuple(
            int(fine[..., o].max()) + 1 for o in range(n_onsets)
        )
        self.r_span = max(self.r_spans)
        self.span_off = span_offsets(self.r_spans)
        self.win_floats = int(self.span_off[-1])
        self.max_shift = int(tt_perm.max())
        r_max = self.r_span - 1
        self.bits = max(1, int(np.ceil(np.log2(r_max + 1)))) if r_max else 1
        self.r_pow2 = 1 << self.bits

    @cached_property
    def fine16(self):
        if self.r_span > FINE16_MAX_SPAN:
            return None
        return np.ascontiguousarray(self.fine.transpose(0, 2, 1), np.int16)


def span_offsets(r_spans, per_onset=True, align=1):
    """
    Offsets of the onsets' staged windows in one block's shared memory:
    int32 [O + 1], onset o's window spanning ``r_spans[o] + SBLK`` floats
    (``per_onset``) or the uniform ``max(r_spans) + SBLK``, each rounded
    up to a multiple of ``align``. The last entry is the windows' size in
    floats. K1 v2 takes the per-onset offsets with ``align`` 1: it reads
    the windows with 4-byte loads.

    """

    widths = np.asarray(r_spans, dtype=np.int64) + SBLK
    if not per_onset:
        widths[:] = widths.max()
    widths = -(-widths // align) * align
    return np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)


def _check_onset_length(onsets, fsmp, nsamples, max_shift):
    """
    The plan clamps traveltimes at 0 but cannot clamp above: migration
    reads ``onsets[fsmp + tt + t]``, so an onset block shorter than the
    plan's largest shift would read past the row. On the card that read
    is silent, so fail loudly on the host first.

    """

    t_len = onsets.shape[-1]
    if fsmp + nsamples + max_shift > t_len:
        raise ValueError(
            f"Onset block too short for this detect plan: migration reads "
            f"up to sample {fsmp + nsamples + max_shift - 1} (fsmp {fsmp} "
            f"+ nsamples {nsamples} + max traveltime shift {max_shift}) "
            f"but the block has {t_len} samples. Rebuild the plan for "
            "this scan geometry."
        )


def combine_tiles(tmax, targ, tsum, perm, tile):
    """
    Cross-tile combine of the per-tile ``[n_tiles, S]`` outputs: the
    per-sample max with the FIRST tile winning ties, the winner's local
    index mapped through ``perm`` to its flat node index, and the grid
    sum. Returns (max_coa, max_idx int32, coa_sum).

    """

    best_tile = torch.argmax(tmax, dim=0)
    max_coa = tmax.gather(0, best_tile[None])[0]
    local = targ.gather(0, best_tile[None])[0].long()
    max_idx = perm[best_tile * tile + local]
    coa_sum = torch.sum(tsum, dim=0)
    return max_coa, max_idx, coa_sum


def plan_acc_chunks(onsets_log, base, fine, fsmp, nsamples,
                    max_elements=2**23):
    """
    The kernels' gather in plain PyTorch: yields ``(c0, acc)`` for chunks
    of consecutive tiles, ``acc[c, n, t] = sum_o L[o, fsmp + base[c0+c, o]
    + fine[c0+c, o, n] + t]`` summed in order o = 0..O-1 as the kernels
    do, each chunk holding at most ``max_elements`` values.

    """

    n_tiles, n_onsets, tile = fine.shape
    t = torch.arange(nsamples, device=onsets_log.device)
    chunk = max(1, max_elements // (tile * nsamples))
    for c0 in range(0, n_tiles, chunk):
        b = base[c0:c0 + chunk].long()
        f = fine[c0:c0 + chunk].long()
        acc = torch.zeros(
            (b.shape[0], tile, nsamples), dtype=onsets_log.dtype,
            device=onsets_log.device,
        )
        for o in range(n_onsets):
            cols = fsmp + b[:, o, None, None] + f[:, o, :, None] + t
            acc = acc + onsets_log[o][cols]
        yield c0, acc


def detect_reduce_plan_reference(onsets_log, base, fine, valid,
                                 inv_available, fsmp, nsamples,
                                 max_elements=2**23):
    """
    Plain PyTorch version of the CUDA kernels, with their exact contract:
    per node tile (in brick order) and sample, the max, the first local
    argmax, and the sum of the coalescence. Onsets are summed in order
    o = 0..O-1, as the kernels do. Tiles are processed in chunks of at
    most ``max_elements`` coalescence values.

    Returns (tmax f32, targ int32, tsum f32), each [n_tiles, nsamples].

    """

    return reduce_acc_chunks(
        plan_acc_chunks(onsets_log, base, fine, fsmp, nsamples, max_elements),
        valid, inv_available,
    )


def reduce_acc_chunks(chunks, valid, inv_available):
    """
    The kernels' epilogue in plain PyTorch over ``(c0, acc)`` chunks of
    per-node onset sums (:func:`plan_acc_chunks`): per tile and sample the
    max, first local argmax and sum of ``exp(acc * inv_available) *
    valid``. Returns (tmax f32, targ int32, tsum f32), each [n_tiles, S].

    """

    tmax, targ, tsum = [], [], []
    for c0, acc in chunks:
        coa = torch.exp(acc * inv_available) * valid[c0:c0 + len(acc), :, None]
        arg = torch.argmax(coa, dim=1)
        tmax.append(coa.gather(1, arg[:, None])[:, 0])
        targ.append(arg.to(torch.int32))
        tsum.append(torch.sum(coa, dim=1))
    return torch.cat(tmax), torch.cat(targ), torch.cat(tsum)


def check_kernel_args(onsets_log, base, fine, valid, inv_available,
                      node_major=False, res_npp=None):
    """
    Checks shared by the kernel wrappers: the kernels' dtypes, contiguity,
    plan shapes that agree, and CUDA tensors on one device. ``fine`` is
    the int32 [n_tiles, O, tile] table, or with ``node_major`` the int16
    [n_tiles, tile, O] table ``DetectPlan.fine16``, or with ``res_npp``
    K2 v2's uint16 table [n_tiles, tile / (16 res_npp), O, 16 res_npp]
    (:func:`vpu_v2_residuals`). Raises on what the kernels do not take.
    Returns (n_onsets, t_len, n_tiles, tile).

    """

    device = onsets_log.device
    fine_dtype, fine_ndim = ((torch.uint16, 4) if res_npp is not None
                             else (torch.int16, 3) if node_major
                             else (torch.int32, 3))
    expected = (
        ("onsets_log", onsets_log, torch.float32, 2),
        ("base", base, torch.int32, 2),
        ("fine", fine, fine_dtype, fine_ndim),
        ("valid", valid, torch.float32, 2),
        ("inv_available", inv_available, torch.float32, 1),
    )
    for name, x, dtype, ndim in expected:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if x.dtype != dtype or x.dim() != ndim:
            raise ValueError(
                f"{name} must be a {ndim}-D {dtype} tensor, got "
                f"{x.dim()}-D {x.dtype}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_onsets, t_len = onsets_log.shape
    n_tiles = fine.shape[0]
    if res_npp is not None:
        slice_ = VPU_NWARPS * res_npp
        tile = fine.shape[1] * slice_
        fine_shape = (n_tiles, tile // slice_, n_onsets, slice_)
    else:
        tile = fine.shape[1] if node_major else fine.shape[2]
        fine_shape = ((n_tiles, tile, n_onsets) if node_major
                      else (n_tiles, n_onsets, tile))
    if (base.shape != (n_tiles, n_onsets)
            or fine.shape != fine_shape
            or valid.shape != (n_tiles, tile)
            or inv_available.numel() != 1):
        raise ValueError(
            f"inconsistent plan shapes: onsets {tuple(onsets_log.shape)}, "
            f"base {tuple(base.shape)}, fine {tuple(fine.shape)}, valid "
            f"{tuple(valid.shape)}, inv_available {tuple(inv_available.shape)}"
        )
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    return n_onsets, t_len, n_tiles, tile


def smem_refusal(smem, what):
    """None where one block may have ``smem`` bytes of shared memory on
    Hopper, else the reason in words."""

    if smem > SMEM_LIMIT:
        return (f"{what} need {smem} bytes of shared memory, over the "
                f"{SMEM_LIMIT} a block may use; use a smaller tile or brick")
    return None


def check_smem(smem, what):
    """Raise when one block would need more shared memory than Hopper
    gives it."""

    reason = smem_refusal(smem, what)
    if reason is not None:
        raise ValueError(reason)


def empty_outputs(n_tiles, nsamples, device):
    """Uninitialised (tmax f32, targ int32, tsum f32) [n_tiles, S]."""

    return tuple(
        torch.empty((n_tiles, nsamples), dtype=dtype, device=device)
        for dtype in (torch.float32, torch.int32, torch.float32)
    )


def launch_kernel(name, device, *args):
    """Call the C entry ``name`` of the kernel library with ``args`` and
    the current stream of ``device``; raise if the launch failed."""

    from quakemigrate_torch import _build

    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.qm_error_string(err).decode()}"
        )


def blocks_per_sm(name, device, *args):
    """Resident blocks per SM that the occupancy API reports for the C
    query ``name`` (``qm_*_blocks_per_sm``) on ``device``; raises on a
    CUDA error."""

    from quakemigrate_torch import _build

    lib = _build.load_library()
    with torch.cuda.device(device):
        blocks = getattr(lib, name)(*args)
    if blocks < 0:
        raise RuntimeError(
            f"{name} failed: {lib.qm_error_string(-blocks).decode()}"
        )
    return blocks


def detect_blocks_per_sm(n_onsets, r_span, device):
    """Resident blocks per SM of K1 at a plan."""

    return blocks_per_sm("qm_migrate_detect_blocks_per_sm", device,
                         n_onsets, r_span)


def launch_staged(entry, onsets_log, base, fine, valid, inv_available,
                  fsmp, nsamples, r_span, *extra):
    """
    Check and launch ``entry``, a kernel that stages every onset's window
    per (tile, SBLK-sample block): K1
    (``qm_migrate_detect``) or its ablations (``extra`` = the variant).
    Returns (tmax f32, targ int32, tsum f32), each [n_tiles, nsamples].

    """

    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine, valid, inv_available
    )
    if tile % NWARPS:
        raise ValueError(f"tile ({tile}) must be a multiple of {NWARPS}")
    if nsamples < 1 or r_span < 1:
        raise ValueError(f"bad geometry: nsamples {nsamples}, r_span {r_span}")
    # One staged window of r_span + SBLK floats per onset, reused for the
    # block reduction
    check_smem(4 * max(n_onsets * (r_span + SBLK), 3 * NWARPS * SBLK),
               f"staged windows ({n_onsets} onsets x ({r_span} + {SBLK}) "
               "floats)")

    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        entry, onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), fine.data_ptr(),
        valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, fsmp,
        nsamples, r_span, *extra,
    )
    return outs


def migrate_detect_cuda(onsets_log, base, fine, valid, inv_available,
                        fsmp, nsamples, r_span):
    """
    Launch the CUDA kernel on tensors on the card. Checks device, dtype,
    contiguity and shapes, and raises on what the kernel does not take.
    Returns (tmax f32, targ int32, tsum f32), each [n_tiles, nsamples].
    The launch is asynchronous on the current stream.

    """

    outs = launch_staged("qm_migrate_detect", onsets_log, base, fine, valid,
                         inv_available, fsmp, nsamples, r_span)
    launches["migrate_detect"] += 1
    return outs


def migrate_marginalise_cuda(onsets_log, base, fine, valid, perm,
                             inv_available, fsmp, nsamples, window_start,
                             window_length, n_nodes, max_shift):
    """
    Launch M1 (``csrc/migrate_marginalise.cu``) on tensors on the card:
    the coalescence of every real node of the plan summed over the scan
    samples ``[window_start, window_start + window_length)``, returned as
    f32 [n_nodes] in flat node order (scattered through ``perm``; padding
    nodes dropped). A window longer than ``M1_CHUNK`` samples is split
    into chunks, one block a node tile and chunk, whose sums are added in
    chunk order. ``fine`` is the plan's int32 [n_tiles, O, tile]
    table, ``perm`` its int32 [n_tiles * tile] flat indices, ``max_shift``
    its largest traveltime. Raises on CPU tensors and on what the kernel
    does not take; the plain version is
    :func:`quakemigrate_torch.ops.migrate.migrate_marginalise`. The launch
    is asynchronous on the current stream.

    """

    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine, valid, inv_available
    )
    if (perm.device != onsets_log.device or perm.dtype != torch.int32
            or perm.shape != (n_tiles * tile,) or not perm.is_contiguous()):
        raise ValueError(f"perm must be a contiguous int32 [{n_tiles * tile}] "
                         f"tensor on {onsets_log.device}")
    if not (0 <= window_start and 0 <= window_length
            and window_start + window_length <= nsamples):
        raise ValueError(
            f"window [{window_start}, {window_start + window_length}) is not "
            f"inside the {nsamples} scan samples"
        )
    _check_onset_length(onsets_log, fsmp, nsamples, max_shift)
    out = torch.empty(n_nodes, dtype=torch.float32, device=onsets_log.device)
    # A window of more than one chunk: one block a node tile x chunk, each
    # chunk's sums into a row of ``partial``, added in chunk order
    n_chunks = max(1, -(-window_length // M1_CHUNK))
    partial = (torch.empty((n_chunks, n_nodes), dtype=torch.float32,
                           device=onsets_log.device) if n_chunks > 1
               else None)
    launch_kernel(
        "qm_migrate_marginalise", onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), fine.data_ptr(),
        valid.data_ptr(), perm.data_ptr(), inv_available.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        n_chunks, n_nodes, n_onsets, n_tiles, tile, fsmp + window_start,
        window_length,
    )
    launches["migrate_marginalise"] += 1
    return out


def v2_smem_bytes(n_onsets, tile, win_floats):
    """
    Shared-memory bytes of one K1 v2 block (``csrc/migrate_detect_v2.cu``):
    the window offsets (O + 1 ints, rounded up to 4), ``valid`` (tile
    floats), and the larger of the uint16 slab (tile x O rounded up to 8)
    with the ``win_floats`` floats of windows, and the block reduction
    that reuses them.

    """

    body = max(2 * tile * round_up(n_onsets, 8) + 4 * win_floats,
               4 * 3 * NWARPS * SBLK)
    return 4 * (round_up(n_onsets + 1, 4) + tile) + body


def v2_smem_refusal(n_onsets, tile, win_floats):
    """None where one K1 v2 block's slab and windows
    (:func:`v2_smem_bytes`) fit Hopper's shared memory, else the reason
    in words."""

    return smem_refusal(
        v2_smem_bytes(n_onsets, tile, win_floats),
        f"the residual slab ({tile} x {n_onsets}) and windows ({win_floats} "
        "floats)")


def v2_refusal(n_onsets, tile, win_floats, r_span):
    """
    Why K1 v2 cannot take a plan of these sizes (a :class:`DetectPlan`'s
    ``n_onsets``, ``tile``, ``win_floats`` and ``r_span``), in words, or
    None where it can: the residual span must fit the int16 table
    ``fine16``, and one block's slab and windows Hopper's shared memory
    (:func:`v2_smem_refusal`). Reads nothing from the card.

    """

    if r_span > FINE16_MAX_SPAN:
        return (f"residual span {r_span} exceeds {FINE16_MAX_SPAN}, the "
                "limit of K1 v2's int16 residual table fine16")
    return v2_smem_refusal(n_onsets, tile, win_floats)


def v2_smem(n_onsets, tile, win_floats):
    """:func:`v2_smem_bytes`; raises when a block cannot have that
    much (:func:`v2_smem_refusal`)."""

    reason = v2_smem_refusal(n_onsets, tile, win_floats)
    if reason is not None:
        raise ValueError(reason)
    return v2_smem_bytes(n_onsets, tile, win_floats)


def _check_span_off(span_off, win_floats, n_onsets, device):
    """Raise unless ``span_off`` is K1 v2's int32 [O + 1] window offsets
    on ``device`` and ``win_floats`` leaves each onset's window at least
    SBLK + 1 floats."""

    if (span_off.device != device or span_off.dtype != torch.int32
            or span_off.shape != (n_onsets + 1,)
            or not span_off.is_contiguous()):
        raise ValueError(
            f"span_off must be a contiguous int32 [{n_onsets + 1}] tensor "
            f"on {device}"
        )
    if win_floats < n_onsets * (SBLK + 1):
        raise ValueError(f"win_floats ({win_floats}) is too small")


def launch_v2(entry, onsets_log, base, fine16, valid, inv_available, fsmp,
              nsamples, span_off, win_floats, *extra):
    """
    Check and launch ``entry``, K1 v2 (``qm_migrate_detect_v2``) or its
    ablations (``extra`` = the variant), on tensors on the card. Returns
    (tmax f32, targ int32, tsum f32), each [n_tiles, nsamples].

    """

    if fine16 is None:
        raise ValueError(
            "the plan has no int16 residual table fine16 (its residual span "
            f"exceeds {FINE16_MAX_SPAN}); K1 v2 cannot take it")
    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine16, valid, inv_available, node_major=True
    )
    if tile % (2 * NWARPS):
        raise ValueError(f"tile ({tile}) must be a multiple of {2 * NWARPS}")
    if nsamples < 1:
        raise ValueError(f"bad geometry: nsamples {nsamples}")
    _check_span_off(span_off, win_floats, n_onsets, onsets_log.device)
    v2_smem(n_onsets, tile, win_floats)

    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        entry, onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), fine16.data_ptr(),
        valid.data_ptr(), inv_available.data_ptr(), span_off.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, fsmp,
        nsamples, win_floats, *extra,
    )
    return outs


def migrate_detect_v2_cuda(onsets_log, base, fine16, valid, inv_available,
                           fsmp, nsamples, span_off, win_floats):
    """
    Launch K1 v2 (``csrc/migrate_detect_v2.cu``) on tensors on the card:
    K1's contract, bit for bit, from the node-major
    int16 residuals ``fine16`` and the window offsets ``span_off`` (int32
    [O + 1] on the card) of a :class:`DetectPlan`; ``win_floats`` is
    ``span_off[-1]``, passed so that sizing the launch reads nothing back
    from the card. Returns (tmax f32, targ int32, tsum f32), each
    [n_tiles, nsamples], asynchronously on the current stream.

    """

    outs = launch_v2("qm_migrate_detect_v2", onsets_log, base, fine16, valid,
                     inv_available, fsmp, nsamples, span_off, win_floats)
    launches["migrate_detect_v2"] += 1
    return outs


def detect_v2_blocks_per_sm(n_onsets, tile, win_floats, device):
    """Resident blocks per SM of K1 v2 at a plan."""

    return blocks_per_sm("qm_migrate_detect_v2_blocks_per_sm", device,
                         n_onsets, tile, win_floats)


def m1_v2_slots(window_length):
    """Samples a lane of M1 v2 adds a node at this window length: 1, 2
    or 4, the fewest that cover the chunk width min(window_length,
    M1_V2_CHUNK) at 32 lanes."""

    width = min(window_length, M1_V2_CHUNK)
    return 1 if width <= 32 else 2 if width <= 64 else 4


def m1_v2_win_floats(n_onsets, win_floats, window_length):
    """Floats of one M1 v2 block's windows and the zeros after them: K1
    v2's ``win_floats`` (each onset's window r_spans[o] + SBLK floats)
    with each window cut to r_spans[o] + the chunk width, plus the 32
    slots - width floats the lanes past the width read."""

    width = min(window_length, M1_V2_CHUNK)
    return (win_floats - n_onsets * (M1_V2_CHUNK - width)
            + 32 * m1_v2_slots(window_length) - width)


def m1_v2_smem_bytes(n_onsets, tile, win_floats, window_length):
    """Shared-memory bytes of one M1 v2 block
    (``csrc/migrate_marginalise_v2.cu``): the window offsets (O + 1
    ints, rounded up to 4), ``valid`` (tile floats), the
    uint16 slab (tile x O rounded up to 8) and the windows
    (:func:`m1_v2_win_floats`). Never more than K1 v2's at the same plan
    (:func:`v2_smem_bytes`)."""

    return (4 * (round_up(n_onsets + 1, 4) + tile)
            + 2 * tile * round_up(n_onsets, 8)
            + 4 * m1_v2_win_floats(n_onsets, win_floats, window_length))


def migrate_marginalise_v2_cuda(onsets_log, base, fine16, valid, perm,
                                inv_available, span_off, win_floats, fsmp,
                                nsamples, window_start, window_length,
                                n_nodes, max_shift):
    """
    Launch M1 v2 (``csrc/migrate_marginalise_v2.cu``) on tensors on the
    card: M1's function (:func:`migrate_marginalise_cuda`), the
    coalescence of every real node of the plan summed over the scan
    samples ``[window_start, window_start + window_length)``, f32
    [n_nodes] in flat node order, from K1 v2's tables of a
    :class:`DetectPlan`: the node-major int16 residuals ``fine16``, the
    window offsets ``span_off`` (int32 [O + 1] on the card) and
    ``win_floats = span_off[-1]``. A window longer than ``M1_V2_CHUNK``
    samples is split into chunks whose sums are added in chunk order; a
    window of one chunk gives M1's result bit for bit. Raises on a plan without ``fine16``, on one whose tile is not a
    multiple of 16 (as K1 v2) or whose block exceeds the shared memory
    (:func:`m1_v2_smem_bytes`), on a window outside the scan,
    on an onset block too short for the plan and on CPU tensors; the
    plain version is
    :func:`quakemigrate_torch.ops.migrate.migrate_marginalise`. The launch
    is asynchronous on the current stream.

    """

    if fine16 is None:
        raise ValueError(
            "the plan has no int16 residual table fine16 (its residual span "
            f"exceeds {FINE16_MAX_SPAN}); M1 v2 cannot take it")
    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine16, valid, inv_available, node_major=True
    )
    if tile % (2 * NWARPS):
        raise ValueError(f"tile ({tile}) must be a multiple of {2 * NWARPS}")
    _check_span_off(span_off, win_floats, n_onsets, onsets_log.device)
    if (perm.device != onsets_log.device or perm.dtype != torch.int32
            or perm.shape != (n_tiles * tile,) or not perm.is_contiguous()):
        raise ValueError(f"perm must be a contiguous int32 [{n_tiles * tile}] "
                         f"tensor on {onsets_log.device}")
    if not (0 <= window_start and 0 <= window_length
            and window_start + window_length <= nsamples):
        raise ValueError(
            f"window [{window_start}, {window_start + window_length}) is not "
            f"inside the {nsamples} scan samples"
        )
    check_smem(m1_v2_smem_bytes(n_onsets, tile, win_floats, window_length),
               f"M1 v2's residual slab ({tile} x {n_onsets}) and windows")
    _check_onset_length(onsets_log, fsmp, nsamples, max_shift)
    out = torch.empty(n_nodes, dtype=torch.float32, device=onsets_log.device)
    n_chunks = max(1, -(-window_length // M1_V2_CHUNK))
    partial = (torch.empty((n_chunks, n_nodes), dtype=torch.float32,
                           device=onsets_log.device) if n_chunks > 1
               else None)
    launch_kernel(
        "qm_migrate_marginalise_v2", onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), fine16.data_ptr(),
        valid.data_ptr(), perm.data_ptr(), inv_available.data_ptr(),
        span_off.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), n_chunks, n_nodes,
        n_onsets, n_tiles, tile, fsmp + window_start, window_length,
        win_floats,
    )
    launches["migrate_marginalise_v2"] += 1
    return out


def marginalise_v2_blocks_per_sm(n_onsets, tile, win_floats, window_length,
                                 device):
    """Resident blocks per SM of M1 v2 at a plan and window length."""

    return blocks_per_sm("qm_migrate_marginalise_v2_blocks_per_sm", device,
                         n_onsets, tile, win_floats, window_length)


def migrate_detect_vpu_cuda(onsets_log, base, fine, valid, inv_available,
                            fsmp, nsamples, r_span):
    """
    Launch the VPU-plan kernel (``csrc/migrate_detect_vpu.cu``, the
    counterpart of the TPU ``_detect_kernel``) on tensors on the card:
    K1's contract, with the block's partial sums held
    in registers while the onsets stream past. ``tile`` must be one of
    ``VPU_TILES``. Returns (tmax f32, targ int32, tsum f32), each
    [n_tiles, nsamples], asynchronously on the current stream.

    """

    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine, valid, inv_available
    )
    if tile not in VPU_TILES:
        raise ValueError(f"tile ({tile}) must be one of {VPU_TILES}")
    if fine.data_ptr() % 16:
        raise ValueError("fine must be 16-byte aligned")
    if nsamples < 1 or r_span < 1:
        raise ValueError(f"bad geometry: nsamples {nsamples}, r_span {r_span}")
    # Two buffers of (fine column + row window), and the reduction
    check_smem(
        4 * (2 * tile + 2 * round_up(r_span + VPU_SBLK, 4)
             + 3 * VPU_NWARPS * VPU_SBLK),
        f"the double-buffered fine column ({tile}) and window ({r_span} + "
        f"{VPU_SBLK} floats)",
    )

    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_vpu", onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), fine.data_ptr(),
        valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, fsmp,
        nsamples, r_span,
    )
    launches["migrate_detect_vpu"] += 1
    return outs


def row_pitch(onsets_log):
    """The onset rows with a pitch TMA takes (a multiple of 4 floats):
    (rows, pitch). Pads a copy only where t_len is not a multiple of 4;
    the columns added lie past t_len, which the kernels read as 0."""

    t_len = onsets_log.shape[1]
    pad = -t_len % 4
    if pad:
        onsets_log = torch.nn.functional.pad(onsets_log, (0, pad))
    return onsets_log, t_len + pad


def vpu_v2_npp(tile):
    """The nodes a warp of K2 v2 takes in one pass over the onsets at
    ``tile`` (:data:`VPU_V2_NPP`); raises on a tile it is not built
    for."""

    if tile not in VPU_V2_NPP:
        raise ValueError(f"tile ({tile}) must be one of {VPU_TILES}")
    return VPU_V2_NPP[tile]


def vpu_v2_layout(r_span):
    """
    Window layout of K2 v2 for a plan's residual span: (stride, box,
    n_boxes). A block's window of onset o holds ``r_span + 3 +
    VPU_V2_SBLK`` floats from the column ``fsmp + base[i, o] + s0``
    rounded down to a multiple of 4 (TMA's inner start must be 16-byte
    aligned); it arrives as ``n_boxes`` TMA boxes of ``box`` floats (a
    multiple of 4, at most 256, and of 32 where there are several, so
    that every box lands 128-byte aligned), and takes ``stride`` floats
    of a ring stage, a multiple of :data:`TMA_ALIGN`.

    """

    width = round_up(r_span + 3 + VPU_V2_SBLK, 4)
    if width <= TMA_MAX_BOX:
        box, n_boxes = width, 1
    else:
        box, n_boxes = TMA_MAX_BOX, -(-width // TMA_MAX_BOX)
    return round_up(box * n_boxes, TMA_ALIGN), box, n_boxes


def vpu_v2_stage_bytes(stride, npp):
    """Bytes of one K2 v2 ring stage: :data:`VPU_V2_GROUP` windows of
    ``stride`` floats and their pass residuals (16 warps x ``npp`` uint16
    each), rounded up to 128 (csrc/migrate_detect_vpu_v2.cu:
    qw_stage_bytes)."""

    return round_up(VPU_V2_GROUP * (4 * stride + 2 * VPU_NWARPS * npp), 128)


def vpu_v2_smem(tile, r_span, stages):
    """
    Shared-memory bytes of one K2 v2 block (csrc/migrate_detect_vpu_v2.cu:
    qw_smem_bytes): 128 bytes of alignment slack, ``stages`` ring stages
    (:func:`vpu_v2_stage_bytes`), the per-thread folds and cross-warp
    reduction (3 x 16 warps x 128 samples of 4 bytes) and 2 ``stages``
    mbarriers. It does not depend on the number of onsets.

    """

    stride, _, _ = vpu_v2_layout(r_span)
    return (128 + stages * vpu_v2_stage_bytes(stride, vpu_v2_npp(tile))
            + 4 * 3 * VPU_NWARPS * VPU_V2_SBLK + 16 * stages)


def vpu_v2_stages(tile, r_span):
    """The deepest ring (:data:`VPU_V2_STAGES`) whose block fits
    Hopper's shared memory at ``tile`` and ``r_span``, or None."""

    fits = [n for n in VPU_V2_STAGES
            if vpu_v2_smem(tile, r_span, n) <= SMEM_LIMIT]
    return max(fits, default=None)


def vpu_v2_refusal(tile, r_span):
    """
    Why K2 v2 cannot take a :class:`DetectPlan` of this ``tile`` and
    ``r_span``, in words, or None where it can: the tile must be one it
    is built for, every residual offset (``r_span`` - 1, plus up to 3 of
    window alignment) must fit its uint16 table, and a ring of two stages
    Hopper's shared memory (:func:`vpu_v2_smem`; the onset count does not
    enter). Reads nothing from the card.

    """

    if tile not in VPU_V2_NPP:
        return f"tile {tile} is not one of K2 v2's {VPU_TILES}"
    if r_span + 2 >= 2**16:
        return (f"residual span {r_span} does not fit K2 v2's uint16 "
                "residual table")
    if vpu_v2_stages(tile, r_span) is None:
        return smem_refusal(
            vpu_v2_smem(tile, r_span, VPU_V2_STAGES[0]),
            f"K2 v2's ring of {VPU_V2_STAGES[0]} stages of "
            f"{VPU_V2_GROUP} windows ({r_span} + {VPU_V2_SBLK} floats)")
    return None


def vpu_v2_order(tile):
    """
    K2 v2's node order inside a tile: ``order[q]`` is the local node
    whose residual sits at entry q, pass-major (the nodes of pass p, then
    warp w's ``npp`` = :func:`vpu_v2_npp` of them): entry ``p * 16 npp +
    w npp + j`` holds node ``w (tile / 16) + p npp + j``.

    """

    npp = vpu_v2_npp(tile)
    npt = tile // VPU_NWARPS
    p, w, j = np.meshgrid(np.arange(npt // npp), np.arange(VPU_NWARPS),
                          np.arange(npp), indexing="ij")
    return (w * npt + p * npp + j).ravel()


def vpu_v2_residuals(fine, base, fsmp):
    """
    K2 v2's residual table for scans that start at ``fsmp``: uint16
    [n_tiles, passes, O, 16 npp] (npp = :func:`vpu_v2_npp` of the tile),
    in the kernel's reading order (pass, then onset, then the pass's
    slice in :func:`vpu_v2_order`), so that
    each (pass, onset) slice and each run of consecutive onsets of a
    pass is contiguous. Entry ``((fsmp + base[i, o]) & 3) + fine[i, o,
    n]`` is node n's read offset in onset o's window, which starts at the
    multiple of 4 at or below ``fsmp + base[i, o]`` (+ s0, a multiple of
    128). ``fine`` and ``base`` are a :class:`DetectPlan`'s.

    """

    fine = np.asarray(fine).astype(np.int64)
    n_tiles, n_onsets, tile = fine.shape
    npp = vpu_v2_npp(tile)
    lead = (fsmp + np.asarray(base).astype(np.int64)) & 3
    entry = lead[:, :, None] + fine[:, :, vpu_v2_order(tile)]
    if entry.size and (entry.min() < 0 or entry.max() >= 2**16):
        raise ValueError(f"a residual offset of {int(entry.max())} does not "
                         "fit K2 v2's uint16 table")
    entry = entry.reshape(n_tiles, n_onsets, -1, VPU_NWARPS * npp)
    return np.ascontiguousarray(entry.transpose(0, 2, 1, 3), np.uint16)


def vpu_v2_tables(plan, fsmp, device):
    """K2 v2's tables for a :class:`DetectPlan` and scans starting at
    ``fsmp``: a namespace with the residual table ``res`` (on ``device``),
    the tile's ``npp``, the window layout (``stride``, ``box``,
    ``n_boxes``), ``r_span`` and ``fsmp``."""

    npp = vpu_v2_npp(plan.tile)
    stride, box, n_boxes = vpu_v2_layout(plan.r_span)
    res = vpu_v2_residuals(plan.fine, plan.base, fsmp)
    return SimpleNamespace(res=torch.from_numpy(res).to(device), npp=npp,
                           stride=stride, box=box, n_boxes=n_boxes,
                           r_span=plan.r_span, fsmp=fsmp)


def vpu_v2_reference(onsets_log, base, valid, inv_available, fsmp, nsamples,
                     tables, max_elements=2**23):
    """
    Plain PyTorch version of K2 v2 (K1's contract) through its tables
    (:func:`vpu_v2_tables`, built for this ``fsmp``): node n reads onset
    o at column ``((fsmp + base[i, o]) & ~3) + res[i, o, q] + t``, q its
    entry in the pass-major order, summed in order o = 0..O-1. Returns
    (tmax f32, targ int32, tsum f32), each [n_tiles, nsamples].

    """

    if tables.fsmp != fsmp:
        raise ValueError(f"the tables were built for fsmp {tables.fsmp}, "
                         f"not {fsmp}")
    n_tiles, passes, n_onsets, slice_ = tables.res.shape
    tile = passes * slice_
    local = torch.empty((n_tiles, n_onsets, tile), dtype=torch.int64,
                        device=tables.res.device)
    order = torch.from_numpy(vpu_v2_order(tile)).to(
        local.device)
    local[:, :, order] = tables.res.long().transpose(1, 2).reshape(
        n_tiles, n_onsets, tile)
    col0 = (fsmp + base.long()) & ~3
    return reduce_acc_chunks(
        plan_acc_chunks(onsets_log, col0, local, 0, nsamples, max_elements),
        valid, inv_available,
    )


def migrate_detect_vpu_v2_cuda(onsets_log, base, valid, inv_available, fsmp,
                               nsamples, tables, n_stages=4):
    """
    Launch K2 v2 (``csrc/migrate_detect_vpu_v2.cu``, the VPU-plan kernel
    on an mbarrier ring) on tensors on the card: K2's contract and node
    order, so its outputs equal K2's bit for bit, through the ``tables``
    of :func:`vpu_v2_tables` (built for this ``fsmp``), with an
    ``n_stages``-deep ring (:data:`VPU_V2_STAGES`) of
    :data:`VPU_V2_GROUP` onsets a stage, whose shared memory does not
    depend on the number of onsets. Returns (tmax f32, targ int32, tsum f32), each
    [n_tiles, nsamples], asynchronously on the current stream.

    """

    t = tables
    if t.fsmp != fsmp:
        raise ValueError(f"the tables were built for fsmp {t.fsmp}, not "
                         f"{fsmp}")
    if n_stages not in VPU_V2_STAGES:
        raise ValueError(f"n_stages ({n_stages}) must be one of "
                         f"{VPU_V2_STAGES}")
    tile = valid.shape[-1]
    if tile not in VPU_TILES:
        raise ValueError(f"tile ({tile}) must be one of {VPU_TILES}")
    npp = vpu_v2_npp(tile)
    if (t.stride, t.box, t.n_boxes) != vpu_v2_layout(t.r_span):
        raise ValueError(f"bad window layout: stride {t.stride}, box {t.box}, "
                         f"n_boxes {t.n_boxes} for r_span {t.r_span}")
    if t.res.data_ptr() % 16:
        raise ValueError("the residual table must be 16-byte aligned")
    if nsamples < 1 or -(-nsamples // VPU_V2_SBLK) > 65535:
        raise ValueError(f"bad geometry: nsamples {nsamples}")
    check_smem(vpu_v2_smem(tile, t.r_span, n_stages),
               f"{n_stages} ring stages of {VPU_V2_GROUP} {t.stride}-float "
               "windows")
    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, t.res, valid, inv_available, res_npp=npp,
    )
    rows, pitch = row_pitch(onsets_log)
    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_vpu_v2", onsets_log.device,
        rows.data_ptr(), t_len, pitch, base.data_ptr(), t.res.data_ptr(),
        valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, fsmp,
        nsamples, t.stride, t.box, t.n_boxes, n_stages,
    )
    launches["migrate_detect_vpu_v2"] += 1
    return outs


def vpu_v2_blocks_per_sm(tile, stride, n_stages, device):
    """Resident blocks per SM of K2 v2 at a tile, window stride and ring
    depth."""

    return blocks_per_sm("qm_migrate_detect_vpu_v2_blocks_per_sm", device,
                         tile, stride, n_stages)


class CudaDetect:
    """
    Fused migrate-and-reduce for one (traveltimes, scan geometry), built
    once and called per window like ``PallasDetectMXU``:
    ``__call__(onsets [O, T], mask [O], available)`` (:meth:`reduce`)
    returns (max_coa, max_idx int32, coa_sum), each [nsamples]; the
    caller normalises.

    The plan lives on ``device``; ``plan``, a :class:`DetectPlan` of the
    traveltimes at this tile and brick, saves building it again. For
    onsets on a CUDA device the CUDA kernel runs, K1 v2
    (:func:`migrate_detect_v2_cuda`, which raises on a plan it cannot
    take: :func:`v2_refusal`), and ``launches`` counts it; for onsets on
    the CPU the plain version (:func:`detect_reduce_plan_reference`)
    runs. :meth:`marginalise`, locate's pass 2, runs M1 v2 on the same
    tables.

    """

    kernel = staticmethod(migrate_detect_v2_cuda)

    def __init__(self, traveltimes, node_count, fsmp, nsamples, device,
                 tile=256, brick_shape=(8, 8, 4), plan=None):
        if plan is None:
            plan = DetectPlan(traveltimes, node_count, tile=tile,
                              brick_shape=brick_shape)
        self.device = resolve_device(device)
        self.fsmp = int(fsmp)
        self.nsamples = int(nsamples)
        self.tile = plan.tile
        self.n_nodes = plan.n_nodes
        self.r_span = plan.r_span
        self._max_shift = plan.max_shift
        self.base = self._put(plan.base)
        self.fine = self._put(plan.fine)
        self.valid = self._put(plan.valid)
        self.perm = self._put(plan.perm)
        self._load(plan)
        self.launches = 0

    def _put(self, a):
        return None if a is None else torch.from_numpy(a).to(self.device)

    def _load(self, plan):
        """K1 v2's tables of the plan, on the device."""

        self.fine16 = self._put(plan.fine16)
        self.span_off = self._put(plan.span_off)
        self.win_floats = plan.win_floats

    def __call__(self, onsets, mask, available):
        return self.reduce(onsets, mask, available)

    def reduce(self, onsets, mask, available):
        """(max_coa, max_idx int32, coa_sum), each [nsamples], of one
        window's onsets [O, T] on the plan's device."""

        return self.reduce_log(*self.prepare(onsets, mask, available))

    def prepare(self, onsets, mask, available):
        """The kernels' inputs of one window's onsets [O, T] on the plan's
        device: (clipped, logged and masked onsets f32 [O, T],
        inv_available f32 [1])."""

        if onsets.device != self.device:
            raise ValueError(
                f"onsets are on {onsets.device}, the plan on {self.device}"
            )
        _check_onset_length(
            onsets, self.fsmp, self.nsamples, self._max_shift
        )
        onsets_log = _prepare_onsets(onsets, mask).to(torch.float32)
        inv_available = (
            1.0 / torch.as_tensor(available, dtype=torch.float32,
                                  device=self.device)
        ).reshape(1)
        return onsets_log.contiguous(), inv_available

    def marginalise(self, onsets_log, inv_available, window_start,
                    window_length):
        """M1 v2 on the plan (:func:`migrate_marginalise_v2_cuda`, K1 v2's
        tables) for prepared onsets on the card: the coalescence of every
        node summed over the scan samples ``[window_start, window_start +
        window_length)``, f32 [n_nodes] in flat node order. Raises on CPU
        tensors."""

        return migrate_marginalise_v2_cuda(
            onsets_log, self.base, self.fine16, self.valid, self.perm,
            inv_available, self.span_off, self.win_floats, self.fsmp,
            self.nsamples, window_start, window_length, self.n_nodes,
            self._max_shift,
        )

    def reduce_log(self, onsets_log, inv_available):
        """(max_coa, max_idx int32, coa_sum), each [nsamples], of prepared
        onsets (:meth:`prepare`): the kernel on a CUDA device, the plain
        version on the CPU."""

        if onsets_log.is_cuda:
            parts = self.launch(onsets_log.contiguous(), inv_available)
            self.launches += 1
        else:
            parts = self.plain(onsets_log, inv_available)
        return combine_tiles(*parts, self.perm, self.tile)

    def launch(self, onsets_log, inv_available):
        """``kernel`` on the plan, for prepared onsets on the card:
        (tmax, targ, tsum), each [n_tiles, nsamples]."""

        return self.kernel(
            onsets_log, self.base, self.fine16, self.valid, inv_available,
            self.fsmp, self.nsamples, self.span_off, self.win_floats,
        )

    def plain(self, onsets_log, inv_available):
        """The kernel's plain version on the plan, for prepared onsets on
        the CPU: (tmax, targ, tsum), each [n_tiles, nsamples]."""

        return detect_reduce_plan_reference(
            onsets_log, self.base, self.fine, self.valid, inv_available,
            self.fsmp, self.nsamples,
        )


class CudaDetectVPU(CudaDetect):
    """
    The counterpart of ``PallasDetect`` (the TPU VPU kernel's wrapper):
    the same plan and contract as :class:`CudaDetect` with the VPU plan's
    defaults (tile 512, bricks 8 x 8 x 8; a ``plan`` of another tile of
    :data:`VPU_TILES` is taken as it is) and the kernel K2 v2,
    :func:`migrate_detect_vpu_v2_cuda`, through its tables
    (:func:`vpu_v2_tables`), with the deepest ring a block can hold
    (:func:`vpu_v2_stages`). ``__call__(onsets, mask, available)``
    returns ``(max_coa, max_coa_n, max_idx)`` like ``PallasDetect``,
    with ``max_coa_n = max_coa * n_nodes / coa_sum``; :meth:`reduce`
    returns :class:`CudaDetect`'s (max_coa, max_idx, coa_sum). CPU
    onsets take K2 v2's plain version (:func:`vpu_v2_reference`) and
    count no launch. K2 (:func:`migrate_detect_vpu_cuda`) stays callable
    on the same plan (``fine``, ``r_span``) as K2 v2's yardstick.
    :meth:`marginalise` runs M1 on the plan's int32 ``fine``, as this is
    the route of plans that K1 v2, and so M1 v2, cannot stage.

    """

    kernel = staticmethod(migrate_detect_vpu_v2_cuda)

    def __init__(self, traveltimes, node_count, fsmp, nsamples, device,
                 tile=512, brick_shape=(8, 8, 8), plan=None):
        tile = tile if plan is None else plan.tile
        if tile not in VPU_TILES:
            raise ValueError(f"tile ({tile}) must be one of {VPU_TILES}")
        if plan is None:
            plan = DetectPlan(traveltimes, node_count, tile=tile,
                              brick_shape=brick_shape)
        super().__init__(traveltimes, node_count, fsmp, nsamples, device,
                         plan=plan)

    def _load(self, plan):
        """K2 v2's tables of the plan, on the device, and its ring depth
        (at least the smallest, with which a plan too wide raises at
        launch)."""

        self.tables = vpu_v2_tables(plan, self.fsmp, self.device)
        self.n_stages = (vpu_v2_stages(plan.tile, plan.r_span)
                         or VPU_V2_STAGES[0])

    def __call__(self, onsets, mask, available):
        max_coa, max_idx, coa_sum = self.reduce(onsets, mask, available)
        return max_coa, max_coa * self.n_nodes / coa_sum, max_idx

    def launch(self, onsets_log, inv_available):
        return self.kernel(
            onsets_log, self.base, self.valid, inv_available, self.fsmp,
            self.nsamples, self.tables, self.n_stages,
        )

    def marginalise(self, onsets_log, inv_available, window_start,
                    window_length):
        """M1 on the plan (:func:`migrate_marginalise_cuda`, the int32
        residuals ``fine``): the route of plans K1 v2, and so M1 v2,
        cannot stage (:func:`v2_refusal`). Raises on CPU tensors."""

        return migrate_marginalise_cuda(
            onsets_log, self.base, self.fine, self.valid, self.perm,
            inv_available, self.fsmp, self.nsamples, window_start,
            window_length, self.n_nodes, self._max_shift,
        )

    def plain(self, onsets_log, inv_available):
        return vpu_v2_reference(
            onsets_log, self.base, self.valid, inv_available, self.fsmp,
            self.nsamples, self.tables,
        )
