# -*- coding: utf-8 -*-
"""
Fused migrate-and-reduce on the GPU: the node-tile plan, the wrappers of
the CUDA kernels ``csrc/migrate_detect.cu`` (K1),
``csrc/migrate_detect_v2.cu`` (K1 v2, the same contract redesigned for
the card's shared-memory pipe), ``csrc/migrate_detect_vpu.cu`` (K2) and
``csrc/migrate_detect_vpu_v2.cu`` (K2 v2, K2 on an mbarrier ring), their
plain PyTorch versions, and the cross-tile combine; of
``csrc/migrate_detect_global.cu`` (K3, the same function on flat node
tiles with the onset rows read from global memory, for the plans no
staged kernel takes) and ``csrc/migrate_detect_global_v2.cu`` (K3 v2,
K3's function on the brick plan with the onset windows streamed through
an mbarrier ring), whose plain version is ``ops.migrate.detect_reduce``;
and the wrapper of
``csrc/migrate_marginalise.cu`` (M1, locate's marginalisation on the same
plan) and ``csrc/migrate_marginalise_v2.cu`` (M1 v2, M1 on K1 v2's
tables), whose plain version is ``ops.migrate.migrate_marginalise``, and
of M2, locate's coalescence map on the same two sources (its main form on
M1 v2's staging, its simple form on M1's gather), whose plain version is
``ops.migrate.migrate_map``; of ``csrc/migrate_detect_global_v3.cu`` (K3
v3 f64, K3 v2 f64's function redesigned for doubles: a persistent ring
that stages each item once on K3 v2 f64's tables, the route's kernel in
float64); and of M1 ring and M2 ring
(``csrc/migrate_marginalise_ring.cu``), the same two functions on K3 v2's
ring of onset windows and tables, locate's pass 2 and map on the routes
whose plans K1 v2 does not stage (``CudaDetectGlobal``,
``CudaDetectVPU``), with plain versions that read the same tables
(:func:`marginalise_ring_reference`, :func:`map_ring_reference`). K3, K3
v2, M1, M2's simple form, M1 ring and M2 ring also have float64 forms
(the same sources on double), for ``QuakeScan(precision="double")``:
their wrappers take float32 or float64 onsets and launch the form of the
onsets' type (M1 ring f64 and M2 ring f64 on K3 v2 f64's tables).

Counterpart of quakemigrate_tpu.ops.pallas_migrate: ``CudaDetect`` of
``PallasDetectMXU`` (kernel ``_mxu_detect_kernel``), ``CudaDetectVPU`` of
``PallasDetect`` (kernel ``_detect_kernel``); ``CudaDetectGlobal`` of the
JAX package's XLA shift-table reduction (``ops.migrate.detect_reduce``).
For the staged kernels the flat node axis is reordered
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
import time
from functools import cached_property
from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.util import round_up
from .migrate import _prepare_onsets, detect_reduce

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

# Consecutive flat nodes a block of K3 takes
# (csrc/migrate_detect_global.cu: QG_TILE)
K3_TILE = 256

# K3 v2 (csrc/migrate_detect_global_v2.cu: GV_SBLK, GV_TILE, GV_SHAPES):
# 128 samples a block; the plan tile it takes; per shape (warps, nodes a
# warp a pass) the blocks per SM it is built for; the ring depths it
# takes; the shape DetectScan's "k3" route launches (the fastest of a
# sweep on the H100 at F3 and Icequake, recorded in PERF.md), and the
# one-block shape it launches where that shape's ring cannot hold the
# plan's widest window (up to about 25,000 samples of residual span, not
# 11,000).
GLOBAL_V2_SBLK = 128
GLOBAL_V2_TILE = 256
GLOBAL_V2_SHAPES = {(32, 8): 1, (16, 8): 2, (16, 16): 1}
GLOBAL_V2_STAGES = (2, 3, 4)
GLOBAL_V2_SHAPE = (16, 8)
GLOBAL_V2_WIDE_SHAPE = (16, 16)
# K3 v2 f64 (csrc/migrate_detect_global_v2.cu: GV_SHAPES_F64): the one
# shape built on double, two passes of 16 warps x 8 nodes, one block an SM
# (its accumulators take twice float's registers)
GLOBAL_V2_SHAPES_F64 = {(16, 8): 1}
# K3 v3 f64 (csrc/migrate_detect_global_v3.cu: GW_FORMS, GW_WARPS): the
# forms it is built for, (nodes a warp takes a round, the onset loop's
# unrolling); the form it runs by the passes of residual slices a stage
# holds: 2 where one stage holds a whole item (every window, both passes),
# 1 where a stage holds G windows and one pass (the fastest of a sweep on
# the H100 at the Icequake window and F3, recorded in PERF.md); 16 warps,
# one persistent block an SM
GLOBAL_V3_FORMS = ((4, 2), (8, 1), (8, 2), (4, 4), (2, 4))
GLOBAL_V3_FORM = {2: (4, 2), 1: (8, 1)}
GLOBAL_V3_WARPS = 16

# M1 ring and M2 ring (csrc/migrate_marginalise_ring.cu: MR_CHUNK,
# MR_SBLK, MR_SHAPES): the window samples a block of M1 ring takes (124,
# so that every read of a window that starts anywhere stays inside K3 v2's
# staged window), the scan samples a block of M2 ring takes, and the
# shapes (warps, nodes a warp a pass) both are built for, with their
# blocks per SM: K3 v2's route shapes.
RING_CHUNK = 124
RING_SBLK = 128
RING_SHAPES = {(16, 8): 2, (16, 16): 1}
# M1 ring f64 and M2 ring f64 (MR_CHUNK_F64, MR_SHAPES_F64): the window
# samples a block of M1 ring f64 takes (128: K3 v2 f64's windows of r + 129
# doubles hold every read of a window that starts anywhere), and K3 v2
# f64's one shape with its blocks per SM at 1 or 2 k slots (one at 4)
RING_CHUNK_F64 = 128
RING_SHAPES_F64 = {(16, 8): 2}

# Shared memory of one SM on Hopper (228 KB), of which each resident
# block reserves 1 KB
SMEM_PER_SM = 233472
SMEM_BLOCK_RESERVE = 1024

# Launches of K1, K1 v2, K2, K2 v2, K3, K3 v2, M1, M1 v2 and M2 (main and
# simple form), of the float64 forms of K3, K3 v2, M1 and M2's simple
# form, of K3 v3 f64, and of M1 ring and M2 ring and their float64 forms,
# counted by their wrappers where they launch
launches = {"migrate_detect": 0, "migrate_detect_v2": 0,
            "migrate_detect_vpu": 0, "migrate_detect_vpu_v2": 0,
            "migrate_detect_global": 0, "migrate_detect_global_v2": 0,
            "migrate_marginalise": 0, "migrate_marginalise_v2": 0,
            "migrate_map": 0, "migrate_map_v2": 0,
            "migrate_detect_global_f64": 0,
            "migrate_detect_global_v2_f64": 0,
            "migrate_detect_global_v3_f64": 0,
            "migrate_marginalise_f64": 0, "migrate_map_f64": 0,
            "migrate_marginalise_ring": 0, "migrate_map_ring": 0,
            "migrate_marginalise_ring_f64": 0, "migrate_map_ring_f64": 0}

# The element types of the onsets the float64-capable wrappers take
FLOAT_DTYPES = (torch.float32, torch.float64)


def reset_launches():
    for name in launches:
        launches[name] = 0


def typed(name, dtype):
    """The name of a kernel's form for onsets of ``dtype``: ``name`` in
    float32, ``name + "_f64"`` in float64 (a C entry or a key of
    :data:`launches`)."""

    return f"{name}_f64" if dtype == torch.float64 else name


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
      kept for parity only; no kernel here uses them;
    - ``nodes``: None for a whole plan; for a slab (:meth:`slab`), the
      sorted flat indices of its real nodes.

    Traveltimes are clamped at 0.

    """

    nodes = None

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

    @classmethod
    def of_tiles(cls, fine, base, valid, perm, n_nodes, r_spans):
        """
        The plan of the per-tile arrays of another plan (``fine`` int32
        [n_tiles, O, tile], ``base``, ``valid``, ``perm`` flat or [n_tiles,
        tile]), as :func:`quakemigrate_torch.parallel.pad_mxu_plan_for_mesh`
        gives them, dead tiles included, for a grid of ``n_nodes`` nodes
        and the whole plan's ``r_spans`` (its windows, and so every slab's
        kernel and route, stay the whole plan's).

        """

        plan = cls.__new__(cls)
        fine = np.ascontiguousarray(fine, np.int32)
        plan.n_tiles, plan.n_onsets, plan.tile = fine.shape
        plan.n_nodes = int(n_nodes)
        plan.fine = fine
        plan.base = np.ascontiguousarray(base, np.int32)
        plan.valid = np.ascontiguousarray(valid, np.float32).reshape(
            plan.n_tiles, plan.tile)
        plan.perm = np.ascontiguousarray(perm, np.int32).ravel()
        plan.r_spans = tuple(int(r) for r in r_spans)
        plan.r_span = max(plan.r_spans)
        plan.span_off = span_offsets(plan.r_spans)
        plan.win_floats = int(plan.span_off[-1])
        live = plan.valid[:, None, :] > 0
        plan.max_shift = int(np.where(
            live, plan.base[..., None] + plan.fine, 0).max(initial=0))
        r_max = plan.r_span - 1
        plan.bits = max(1, int(np.ceil(np.log2(r_max + 1)))) if r_max else 1
        plan.r_pow2 = 1 << plan.bits
        return plan

    def slab(self, start, stop):
        """
        Tiles ``[start, stop)`` of the plan as a plan of their own: a node
        slab of a mesh's grid axis. Tiles past the plan's last are dead
        (valid 0; base, fine and perm 0). ``perm`` stays global, so a
        slab's combine gives global flat indices; ``n_nodes``, the
        residual spans, the window offsets and ``max_shift`` stay the
        whole plan's, so every slab takes the whole plan's kernel route
        and its marginalisation writes into ``[n_nodes]``. ``nodes`` is
        the sorted flat indices of the slab's real nodes.

        """

        n = stop - start

        def take(a):
            part = a[start:min(stop, self.n_tiles)]
            pad = n - part.shape[0]
            if pad:
                part = np.concatenate(
                    [part, np.zeros((pad,) + a.shape[1:], a.dtype)])
            return np.ascontiguousarray(part)

        out = type(self).__new__(type(self))
        out.__dict__.update({k: v for k, v in self.__dict__.items()
                             if k != "fine16"})
        out.n_tiles = n
        out.base, out.fine, out.valid = (take(self.base), take(self.fine),
                                         take(self.valid))
        out.perm = take(self.perm.reshape(self.n_tiles, self.tile)).ravel()
        out.nodes = np.sort(out.perm[out.valid.ravel() > 0]).astype(np.int64)
        return out

    def slabs(self, n_slabs):
        """The plan's tiles in ``n_slabs`` slabs of ``ceil(n_tiles /
        n_slabs)`` tiles (:meth:`slab`), the last ones padded with dead
        tiles, as ``pad_mxu_plan_for_mesh`` pads the tile axis."""

        per = -(-self.n_tiles // n_slabs)
        return [self.slab(i * per, (i + 1) * per) for i in range(n_slabs)]

    def flat_rows(self):
        """(nodes, tt): the flat indices of the plan's real nodes
        (``nodes``, or every node of a whole plan), sorted, and their
        traveltimes ``base + fine`` (clamped at 0), int32 [len(nodes),
        O]: the flat table of K3 on this plan."""

        live = self.valid.ravel() > 0
        flat = self.perm[live].astype(np.int64)
        tt = (self.base[:, :, None] + self.fine).transpose(0, 2, 1).reshape(
            -1, self.n_onsets)[live]
        order = np.argsort(flat, kind="stable")
        return flat[order], np.ascontiguousarray(tt[order], np.int32)


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
                      node_major=False, res_npp=None,
                      dtypes=(torch.float32,)):
    """
    Checks shared by the kernel wrappers: the kernels' dtypes, contiguity,
    plan shapes that agree, and CUDA tensors on one device. ``fine`` is
    the int32 [n_tiles, O, tile] table, or with ``node_major`` the int16
    [n_tiles, tile, O] table ``DetectPlan.fine16``, or with ``res_npp``
    K2 v2's uint16 table [n_tiles, tile / (16 res_npp), O, 16 res_npp]
    (:func:`vpu_v2_residuals`). ``onsets_log`` is one of ``dtypes`` (the
    element types the kernel has a form for), and ``inv_available`` of
    its type. Raises on what the kernels do not take. Returns (n_onsets,
    t_len, n_tiles, tile).

    """

    device = onsets_log.device
    fine_dtype, fine_ndim = ((torch.uint16, 4) if res_npp is not None
                             else (torch.int16, 3) if node_major
                             else (torch.int32, 3))
    dtype = onsets_log.dtype if onsets_log.dtype in dtypes else dtypes[0]
    expected = (
        ("onsets_log", onsets_log, dtype, 2),
        ("base", base, torch.int32, 2),
        ("fine", fine, fine_dtype, fine_ndim),
        ("valid", valid, torch.float32, 2),
        ("inv_available", inv_available, dtype, 1),
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


def empty_outputs(n_tiles, nsamples, device, dtype=torch.float32):
    """Uninitialised (tmax, targ int32, tsum) [n_tiles, S], tmax and tsum
    of ``dtype``."""

    return tuple(
        torch.empty((n_tiles, nsamples), dtype=d, device=device)
        for d in (dtype, torch.int32, dtype)
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
    [n_nodes] in flat node order (scattered through ``perm``; padding
    nodes dropped), in the onsets' type: M1 on float32 onsets, M1 f64 on
    float64. A window longer than ``M1_CHUNK`` samples is split
    into chunks, one block a node tile and chunk, whose sums are added in
    chunk order. ``fine`` is the plan's int32 [n_tiles, O, tile]
    table, ``perm`` its int32 [n_tiles * tile] flat indices, ``max_shift``
    its largest traveltime. Raises on CPU tensors and on what the kernel
    does not take; the plain version is
    :func:`quakemigrate_torch.ops.migrate.migrate_marginalise`. The launch
    is asynchronous on the current stream.

    """

    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine, valid, inv_available, dtypes=FLOAT_DTYPES
    )
    dtype = onsets_log.dtype
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
    out = torch.empty(n_nodes, dtype=dtype, device=onsets_log.device)
    # A window of more than one chunk: one block a node tile x chunk, each
    # chunk's sums into a row of ``partial``, added in chunk order
    n_chunks = max(1, -(-window_length // M1_CHUNK))
    partial = (torch.empty((n_chunks, n_nodes), dtype=dtype,
                           device=onsets_log.device) if n_chunks > 1
               else None)
    launch_kernel(
        typed("qm_migrate_marginalise", dtype), onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), fine.data_ptr(),
        valid.data_ptr(), perm.data_ptr(), inv_available.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        n_chunks, n_nodes, n_onsets, n_tiles, tile, fsmp + window_start,
        window_length,
    )
    launches[typed("migrate_marginalise", dtype)] += 1
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


def _check_map_args(onsets_log, perm, n_tiles, tile, fsmp, nsamples,
                    max_shift):
    """Checks of M2's wrappers beyond :func:`check_kernel_args`: ``perm``
    on the onsets' device, at least one scan sample and an onset block
    long enough for the plan."""

    if (perm.device != onsets_log.device or perm.dtype != torch.int32
            or perm.shape != (n_tiles * tile,) or not perm.is_contiguous()):
        raise ValueError(f"perm must be a contiguous int32 [{n_tiles * tile}] "
                         f"tensor on {onsets_log.device}")
    if nsamples < 1 or fsmp < 0:
        raise ValueError(f"bad geometry: fsmp {fsmp}, nsamples {nsamples}")
    _check_onset_length(onsets_log, fsmp, nsamples, max_shift)


def migrate_map_v2_cuda(onsets_log, base, fine16, valid, perm, inv_available,
                        span_off, win_floats, fsmp, nsamples, n_nodes,
                        max_shift):
    """
    Launch M2 (``csrc/migrate_marginalise_v2.cu``: a store epilogue on M1
    v2's staging) on tensors on the card: the coalescence map of locate,
    f32 [n_nodes, nsamples] in flat node order, ``map[n, t] =
    exp(inv_available * sum_o L[o, fsmp + tt[n, o] + t])``, from K1 v2's
    tables of a :class:`DetectPlan` (``fine16``, ``span_off``,
    ``win_floats``). The onsets are summed in order and each value is
    computed as K1 v2 computes it, so the map's per-sample max equals K1
    v2's tmax bit for bit. Raises on a plan without ``fine16``, on a tile
    that is not a multiple of 16, on a block over the shared memory (M1
    v2's at a window of ``nsamples``, :func:`m1_v2_smem_bytes`), on an
    onset block too short for the plan and on CPU tensors; the plain
    version is :func:`quakemigrate_torch.ops.migrate.migrate_map`. The
    launch is asynchronous on the current stream.

    """

    if fine16 is None:
        raise ValueError(
            "the plan has no int16 residual table fine16 (its residual span "
            f"exceeds {FINE16_MAX_SPAN}); M2 cannot take it")
    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine16, valid, inv_available, node_major=True
    )
    if tile % (2 * NWARPS):
        raise ValueError(f"tile ({tile}) must be a multiple of {2 * NWARPS}")
    _check_span_off(span_off, win_floats, n_onsets, onsets_log.device)
    _check_map_args(onsets_log, perm, n_tiles, tile, fsmp, nsamples,
                    max_shift)
    check_smem(m1_v2_smem_bytes(n_onsets, tile, win_floats, nsamples),
               f"M2's residual slab ({tile} x {n_onsets}) and windows")
    out = torch.empty((n_nodes, nsamples), dtype=torch.float32,
                      device=onsets_log.device)
    launch_kernel(
        "qm_migrate_map_v2", onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), fine16.data_ptr(),
        valid.data_ptr(), perm.data_ptr(), inv_available.data_ptr(),
        span_off.data_ptr(), out.data_ptr(), n_onsets, n_tiles, tile, fsmp,
        nsamples, win_floats,
    )
    launches["migrate_map_v2"] += 1
    return out


def migrate_map_cuda(onsets_log, base, fine, valid, perm, inv_available,
                     fsmp, nsamples, n_nodes, max_shift):
    """
    Launch M2's simple form (``csrc/migrate_marginalise.cu``: M1's
    gather, the onsets read from global memory) on tensors on the card:
    :func:`migrate_map_v2_cuda`'s map, bit for bit, from the plan's int32
    residuals ``fine``, for the plans K1 v2 cannot stage (CudaDetectVPU's
    and CudaDetectGlobal's routes), in the onsets' type (M2 simple f64 on
    float64 onsets). Raises on CPU tensors and on what the kernel does
    not take; the plain version is
    :func:`quakemigrate_torch.ops.migrate.migrate_map`.

    """

    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine, valid, inv_available, dtypes=FLOAT_DTYPES
    )
    dtype = onsets_log.dtype
    _check_map_args(onsets_log, perm, n_tiles, tile, fsmp, nsamples,
                    max_shift)
    if 4 * n_onsets > 48 * 1024:
        raise ValueError(f"M2's simple form takes at most {12 * 1024} "
                         f"onsets, not {n_onsets}")
    out = torch.empty((n_nodes, nsamples), dtype=dtype,
                      device=onsets_log.device)
    launch_kernel(
        typed("qm_migrate_map", dtype), onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), fine.data_ptr(),
        valid.data_ptr(), perm.data_ptr(), inv_available.data_ptr(),
        out.data_ptr(), n_onsets, n_tiles, tile, fsmp, nsamples,
    )
    launches[typed("migrate_map", dtype)] += 1
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


def migrate_detect_global_cuda(onsets_log, tt, inv_available, fsmp,
                               nsamples):
    """
    Launch K3 (``csrc/migrate_detect_global.cu``) on tensors on the card:
    for tiles of :data:`K3_TILE` consecutive flat nodes of the int32
    flat-order traveltimes ``tt`` [n_nodes, O] (clamped to ``[0, T -
    fsmp - nsamples]`` as the plain version clamps them) and each scan
    sample, the max, the first flat node index attaining it and the sum
    of ``exp(sum_o L[o, fsmp + tt[n, o] + t] * inv_available)`` over the
    tile's nodes. The onset rows are read from global memory, so any
    residual span is taken. Float32 onsets take K3, float64 onsets K3 f64
    (``inv_available`` of the onsets' type). Returns (tmax, targ int32
    flat indices, tsum), each [n_tiles, nsamples], tmax and tsum in the
    onsets' type, asynchronously on the current stream;
    :func:`combine_flat_tiles` finishes the reduction. The plain version
    is :func:`quakemigrate_torch.ops.migrate.detect_reduce`.

    """

    device = onsets_log.device
    ftype = (onsets_log.dtype if onsets_log.dtype in FLOAT_DTYPES
             else torch.float32)
    for name, x, dtype in (("onsets_log", onsets_log, ftype),
                           ("tt", tt, torch.int32),
                           ("inv_available", inv_available, ftype)):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor")
    if onsets_log.dim() != 2 or tt.dim() != 2 or inv_available.numel() != 1:
        raise ValueError(
            f"bad shapes: onsets {tuple(onsets_log.shape)}, tt "
            f"{tuple(tt.shape)}, inv_available {tuple(inv_available.shape)}")
    n_onsets, t_len = onsets_log.shape
    n_nodes = tt.shape[0]
    if tt.shape[1] != n_onsets or n_nodes < 1:
        raise ValueError(f"tt {tuple(tt.shape)} does not match {n_onsets} "
                         "onset rows")
    if fsmp < 0 or nsamples < 1 or t_len < fsmp + nsamples:
        raise ValueError(f"bad geometry: fsmp {fsmp}, nsamples {nsamples}, "
                         f"{t_len} onset samples")
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    outs = empty_outputs(-(-n_nodes // K3_TILE), nsamples, device, ftype)
    launch_kernel(
        typed("qm_migrate_detect_global", ftype), device,
        onsets_log.data_ptr(), t_len, tt.data_ptr(),
        inv_available.data_ptr(), *(x.data_ptr() for x in outs), n_nodes,
        n_onsets, K3_TILE, fsmp, nsamples,
    )
    launches[typed("migrate_detect_global", ftype)] += 1
    return outs


def combine_flat_tiles(tmax, targ, tsum):
    """K3's cross-tile combine of its ``[n_tiles, S]`` outputs on FLAT
    tiles (runs of :data:`K3_TILE` consecutive flat nodes): the
    per-sample max with the FIRST tile winning ties (``torch.argmax``),
    that tile's flat node index, and the grid sum. Tile i holds only
    flat indices below tile i + 1's, so with K3's first index within a
    tile, ties go to the first flat index, the plain version's rule; on
    brick tiles that does not hold (:func:`combine_brick_tiles`).
    Returns (max_coa, max_idx int32, coa_sum)."""

    best_tile = torch.argmax(tmax, dim=0)[None]
    return (tmax.gather(0, best_tile)[0], targ.gather(0, best_tile)[0],
            torch.sum(tsum, dim=0))


def combine_brick_tiles(tmax, targ, tsum):
    """K3 v2's cross-tile combine of its ``[n_tiles, S]`` outputs on the
    plan's BRICK tiles, whose ``targ`` holds flat node indices: the
    per-sample max, the smallest flat index among the tiles that attain
    it, and the grid sum. With K3 v2's smallest flat index within a
    tile, ties go to the first flat index, the plain version's rule,
    whatever the tiles' order. Returns (max_coa, max_idx int32,
    coa_sum)."""

    max_coa = torch.amax(tmax, dim=0)
    max_idx = torch.where(tmax == max_coa, targ,
                          torch.iinfo(torch.int32).max).amin(dim=0)
    return max_coa, max_idx.to(torch.int32), torch.sum(tsum, dim=0)


def detect_reduce_flat_reference(onsets_log, tt, inv_available, fsmp,
                                 nsamples, tile=K3_TILE,
                                 max_elements=2**23):
    """
    K3's function in plain PyTorch on prepared onsets, with the kernels'
    arithmetic: per flat tile of ``tile`` nodes of the flat-order int32
    traveltimes ``tt`` [n_nodes, O] (clamped to ``[0, T - fsmp -
    nsamples]``) and sample, the max, the first flat index attaining it
    and the sum of ``exp(acc * inv_available)``, ``acc`` summed in order
    o = 0..O-1. Its max equals K3's and K3 v2's bit for bit where
    ``torch.exp`` rounds as the kernels' ``expf``, and
    :func:`combine_flat_tiles` of it gives the first flat argmax. Returns
    (tmax f32, targ int32 flat indices, tsum f32), each [n_tiles, S].

    """

    n_nodes, n_onsets = tt.shape
    d_max = onsets_log.shape[-1] - fsmp - nsamples
    t = torch.arange(nsamples, device=onsets_log.device)
    per = max(1, max_elements // (tile * nsamples)) * tile
    tmax, targ, tsum = [], [], []
    for n0 in range(0, n_nodes, per):
        cols = fsmp + torch.clamp(tt[n0:n0 + per].long(), 0, d_max)
        acc = torch.zeros((cols.shape[0], nsamples), dtype=onsets_log.dtype,
                          device=onsets_log.device)
        for o in range(n_onsets):
            acc = acc + onsets_log[o][cols[:, o, None] + t]
        coa = torch.exp(acc * inv_available)
        for c0 in range(0, coa.shape[0], tile):
            part = coa[c0:c0 + tile]
            arg = torch.argmax(part, dim=0)
            tmax.append(part.gather(0, arg[None])[0])
            targ.append((n0 + c0 + arg).to(torch.int32))
            tsum.append(torch.sum(part, dim=0))
    return torch.stack(tmax), torch.stack(targ), torch.stack(tsum)


def global_v2_unit(dtype=torch.float32):
    """Elements of ``dtype`` in a 16-byte bulk-copy unit of K3 v2: 4
    floats, 2 doubles."""

    return 16 // global_v2_itemsize(dtype)


def global_v2_itemsize(dtype=torch.float32):
    """Bytes of one onset element of K3 v2 on ``dtype`` (float32 or
    float64)."""

    if dtype not in FLOAT_DTYPES:
        raise ValueError(f"K3 v2 has no form for {dtype}")
    return dtype.itemsize


def global_v2_shapes(dtype=torch.float32):
    """K3 v2's shapes on ``dtype`` and the blocks per SM each is built
    for: :data:`GLOBAL_V2_SHAPES` in float32, :data:`GLOBAL_V2_SHAPES_F64`
    in float64."""

    return (GLOBAL_V2_SHAPES_F64 if global_v2_itemsize(dtype) == 8
            else GLOBAL_V2_SHAPES)


def global_v2_widths(r_spans, dtype=torch.float32):
    """K3 v2's window of each onset, in elements of ``dtype``:
    ``r_spans[o] + (unit - 1) +`` :data:`GLOBAL_V2_SBLK` rounded up to a
    multiple of the 16-byte unit (:func:`global_v2_unit`: the 0-3 floats
    or 0-1 doubles from the 16-byte aligned column, and whole 16-byte
    units of a bulk copy)."""

    unit = global_v2_unit(dtype)
    return np.asarray([round_up(int(r) + unit - 1 + GLOBAL_V2_SBLK, unit)
                       for r in r_spans], dtype=np.int64)


def global_v2_budget(shape, dtype=torch.float32):
    """Shared-memory bytes one K3 v2 block of ``shape`` may use, for the
    blocks per SM the shape is built for on ``dtype``
    (:func:`global_v2_shapes`)."""

    per_sm = global_v2_shapes(dtype)[shape]
    return min(SMEM_LIMIT, SMEM_PER_SM // per_sm - SMEM_BLOCK_RESERVE)


def global_v2_smem(shape, stage_floats, group, n_stages, dtype=torch.float32):
    """
    Shared-memory bytes of one K3 v2 block (csrc/migrate_detect_global_v2.cu:
    gv_smem_bytes): ``n_stages`` ring stages, each ``stage_floats``
    elements of ``dtype`` of windows and ``group`` residual slices of 256
    / passes uint16 (rounded up to 128 bytes), the fold and reduction
    scratch (warps x 128 entries of a max and a sum of ``dtype`` and a
    4-byte argmax) and 2 ``n_stages`` mbarriers.

    """

    warps, npp = shape
    item = global_v2_itemsize(dtype)
    stage = round_up(item * stage_floats + 2 * group * warps * npp, 128)
    return (n_stages * stage + (2 * item + 4) * warps * GLOBAL_V2_SBLK
            + 16 * n_stages)


def global_v2_layout(r_spans, shape=GLOBAL_V2_SHAPE, group=None,
                     dtype=torch.float32):
    """
    K3 v2's ring for a plan's per-onset residual spans, for onsets of
    ``dtype`` (K3 v2 in float32, K3 v2 f64 in float64): a namespace with
    the ``shape`` (warps, npp), ``group`` G (consecutive onsets a
    stage), ``stage_floats`` (the widest group's windows, in elements),
    ``win`` int32 [O, 2] (each onset's window offset in its stage and
    width, elements, multiples of the 16-byte unit;
    :func:`global_v2_widths`), ``n_stages``, the block's ``smem`` bytes
    and the ``dtype``; or None where two stages of one window do not fit
    the shape's budget (:func:`global_v2_budget`). By default G is the
    most onsets for which two stages fit beside the fold scratch (fewer,
    larger stages ran faster than deeper rings in a sweep on the H100),
    and the ring the deepest of :data:`GLOBAL_V2_STAGES` that fits at
    that G; ``group`` fixes G (and the layout is None where two stages of
    it do not fit). Reads nothing from the card.

    """

    widths = global_v2_widths(r_spans, dtype)
    n_onsets = len(widths)
    budget = global_v2_budget(shape, dtype)

    def fit(g):
        starts = np.arange(n_onsets) // g * g
        off = np.zeros(n_onsets, np.int64)
        for o in range(n_onsets):
            off[o] = 0 if starts[o] == o else off[o - 1] + widths[o - 1]
        stage_floats = int((off + widths).max())
        depths = [n for n in GLOBAL_V2_STAGES
                  if global_v2_smem(shape, stage_floats, g, n, dtype)
                  <= budget]
        if not depths or stage_floats > np.iinfo(np.uint16).max:
            return None
        return SimpleNamespace(
            shape=shape, group=g, stage_floats=stage_floats,
            win=np.stack([off, widths], axis=1).astype(np.int32),
            n_stages=max(depths), dtype=dtype,
            smem=global_v2_smem(shape, stage_floats, g, max(depths), dtype))

    if group is not None:
        return fit(group)
    for g in range(n_onsets, 0, -1):
        layout = fit(g)
        if layout is not None:
            return layout
    return None


def global_v2_route_shapes(dtype=torch.float32):
    """The shapes K3 v2 runs on ``dtype``, in the order they are tried:
    :data:`GLOBAL_V2_SHAPE`, then :data:`GLOBAL_V2_WIDE_SHAPE`, in
    float32; the one shape of :data:`GLOBAL_V2_SHAPES_F64` in float64."""

    if global_v2_itemsize(dtype) == 8:
        return tuple(GLOBAL_V2_SHAPES_F64)
    return GLOBAL_V2_SHAPE, GLOBAL_V2_WIDE_SHAPE


def global_v2_shape(r_spans, dtype=torch.float32):
    """The shape K3 v2 runs on ``dtype`` for a plan's per-onset residual
    spans: the first of :func:`global_v2_route_shapes` where a ring of two
    stages of its widest window fits that shape's budget (float32:
    :data:`GLOBAL_V2_SHAPE`, else :data:`GLOBAL_V2_WIDE_SHAPE`, one block
    an SM), else None."""

    for shape in global_v2_route_shapes(dtype):
        if global_v2_layout(r_spans, shape, group=1, dtype=dtype) is not None:
            return shape
    return None


def global_v2_refusal(plan, dtype=torch.float32):
    """
    Why K3 v2 cannot take a :class:`DetectPlan` for onsets of ``dtype``,
    in words, or None where it can: the plan's tile must be
    :data:`GLOBAL_V2_TILE` and a ring of two stages of its widest window
    must fit a block's shared memory in one of the shapes
    :func:`global_v2_shape` tries (about 25,000 samples of residual span
    in float32, about 11,800 in float64, whose ring holds doubles). Reads
    nothing from the card.

    """

    if plan.tile != GLOBAL_V2_TILE:
        return f"tile {plan.tile} is not K3 v2's {GLOBAL_V2_TILE}"
    if global_v2_shape(plan.r_spans, dtype) is None:
        shape = global_v2_route_shapes(dtype)[-1]
        widest = int(global_v2_widths([plan.r_span], dtype)[0])
        kind = "doubles" if global_v2_itemsize(dtype) == 8 else "floats"
        smem = global_v2_smem(shape, widest, 1, GLOBAL_V2_STAGES[0], dtype)
        return (f"K3 v2's ring of {GLOBAL_V2_STAGES[0]} stages of one "
                f"window of {widest} {kind} (residual span {plan.r_span}) "
                f"needs {smem} bytes of shared memory, over the "
                f"{global_v2_budget(shape, dtype)} a block may use")
    return None


def global_v2_tables(plan, fsmp, device, layout):
    """
    K3 v2's tables of a :class:`DetectPlan` for scans that start at
    ``fsmp``, for the ring ``layout`` (:func:`global_v2_layout`, of its
    ``dtype``): a namespace with ``res`` uint16 [n_tiles, passes, O, tile
    / passes] (passes = tile / (warps npp), the plan's tile: K3 v2 takes
    :data:`GLOBAL_V2_TILE`, M1 ring and M2 ring any tile the shape
    divides), in the kernels' reading order, entry ``win[o, 0] + ((fsmp +
    base[i, o]) & (unit - 1)) + fine[i, o, n]`` for the brick-order node
    ``n = p (tile / passes) + q`` (unit the elements of a 16-byte copy,
    :func:`global_v2_unit`); ``flat`` int32 [n_tiles, tile], each
    brick-order node's flat index or -1 for padding; ``win`` int32 [O,
    2]; all on ``device``; and the ``layout`` and ``fsmp``. Raises where
    the shape's warps x npp do not divide the tile.

    """

    warps, npp = layout.shape
    if plan.tile % (warps * npp):
        raise ValueError(f"tile {plan.tile} is not a multiple of the "
                         f"shape's {warps * npp} nodes a pass")
    passes = plan.tile // (warps * npp)
    lead = (fsmp + plan.base) & (global_v2_unit(layout.dtype) - 1)
    # int32 arithmetic: every entry lies below the stage's 2^16 elements
    entry = plan.fine + (layout.win[None, :, 0, None] + lead[:, :, None])
    if entry.size and entry.max() >= layout.stage_floats:
        raise ValueError(f"a residual offset of {int(entry.max())} lies "
                         f"past the {layout.stage_floats}-element stage")
    res = entry.reshape(plan.n_tiles, plan.n_onsets, passes, -1)
    res = np.ascontiguousarray(res.transpose(0, 2, 1, 3), np.uint16)
    flat = np.where(plan.valid > 0, plan.perm.reshape(plan.valid.shape), -1)
    return SimpleNamespace(
        res=torch.from_numpy(res).to(device),
        flat=torch.from_numpy(flat.astype(np.int32)).to(device),
        win=torch.from_numpy(layout.win).to(device), layout=layout,
        fsmp=fsmp)


def migrate_detect_global_v2_cuda(onsets_log, base, inv_available, fsmp,
                                  nsamples, tables, max_shift):
    """
    Launch K3 v2 (``csrc/migrate_detect_global_v2.cu``) on tensors on
    the card: K3's function on the plan's brick tiles through the
    ``tables`` of :func:`global_v2_tables` (built for this ``fsmp``),
    the onset windows streamed through the tables' ring. The onsets (and
    ``inv_available``) are of the ring layout's ``dtype``: float32 takes
    K3 v2, float64 K3 v2 f64. ``max_shift``
    is the plan's largest traveltime: ``fsmp + nsamples + max_shift``
    must fit the onset block, so no traveltime needs K3's clamp. Returns
    (tmax, targ int32 flat indices, tsum), each [n_tiles, nsamples], tmax
    and tsum of the onsets' type, asynchronously on the current stream;
    :func:`combine_brick_tiles` finishes the reduction. The plain
    version is :func:`quakemigrate_torch.ops.migrate.detect_reduce`.

    """

    t = tables
    layout = t.layout
    dtype = layout.dtype
    n_onsets, n_tiles = _check_global_v2(
        onsets_log, base, inv_available, fsmp, nsamples, t, max_shift,
        global_v2_smem(layout.shape, layout.stage_floats, layout.group,
                       layout.n_stages, dtype),
        f"K3 v2's {layout.n_stages} ring stages of {layout.group} windows")
    device = onsets_log.device
    rows, pitch = row_pitch(onsets_log)
    outs = empty_outputs(n_tiles, nsamples, device, dtype)
    launch_kernel(
        typed("qm_migrate_detect_global_v2", dtype), device,
        rows.data_ptr(), pitch, base.data_ptr(), t.res.data_ptr(),
        t.flat.data_ptr(), t.win.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, fsmp, nsamples,
        layout.group, layout.stage_floats, layout.n_stages, *layout.shape,
    )
    launches[typed("migrate_detect_global_v2", dtype)] += 1
    return outs


def _check_global_v2(onsets_log, base, inv_available, fsmp, nsamples,
                     tables, max_shift, smem, what):
    """The checks of K3 v2's wrapper (and K3 v3 f64's) before a launch on
    ``tables`` (:func:`global_v2_tables`): built for this ``fsmp``, a
    shape and depth K3 v2 is built for on the tables' type, the block's
    ``smem`` bytes (``what`` they hold, in words), the tensors' devices,
    types, contiguity and shapes, the geometry, a CUDA device. Returns
    (n_onsets, n_tiles)."""

    t = tables
    layout = t.layout
    dtype = layout.dtype
    shapes = global_v2_shapes(dtype)
    if t.fsmp != fsmp:
        raise ValueError(f"the tables were built for fsmp {t.fsmp}, not "
                         f"{fsmp}")
    if layout.shape not in shapes:
        raise ValueError(f"shape {layout.shape} is not one of "
                         f"{tuple(shapes)} ({dtype})")
    if layout.n_stages not in GLOBAL_V2_STAGES:
        raise ValueError(f"n_stages ({layout.n_stages}) must be one of "
                         f"{GLOBAL_V2_STAGES}")
    if nsamples < 1 or -(-nsamples // GLOBAL_V2_SBLK) > 65535:
        raise ValueError(f"bad geometry: nsamples {nsamples}")
    check_smem(smem, what)
    device = onsets_log.device
    for name, x, want in (("onsets_log", onsets_log, dtype),
                          ("base", base, torch.int32),
                          ("inv_available", inv_available, dtype),
                          ("res", t.res, torch.uint16),
                          ("flat", t.flat, torch.int32),
                          ("win", t.win, torch.int32)):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if x.dtype != want or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} tensor")
    n_onsets, t_len = onsets_log.shape
    n_tiles = base.shape[0]
    passes = t.res.shape[1]
    if (base.shape[1:] != (n_onsets,)
            or t.res.shape != (n_tiles, passes, n_onsets,
                               GLOBAL_V2_TILE // passes)
            or passes * layout.shape[0] * layout.shape[1] != GLOBAL_V2_TILE
            or t.flat.shape != (n_tiles, GLOBAL_V2_TILE)
            or t.win.shape != (n_onsets, 2)
            or inv_available.numel() != 1):
        raise ValueError(
            f"inconsistent shapes: onsets {tuple(onsets_log.shape)}, base "
            f"{tuple(base.shape)}, res {tuple(t.res.shape)}, flat "
            f"{tuple(t.flat.shape)}, win {tuple(t.win.shape)}, shape "
            f"{layout.shape}")
    if fsmp < 0 or t_len < fsmp + nsamples + max_shift:
        raise ValueError(f"bad geometry: fsmp {fsmp}, nsamples {nsamples} "
                         f"and traveltimes up to {max_shift} need "
                         f"{fsmp + nsamples + max_shift} onset samples, the "
                         f"block has {t_len}")
    if t.res.data_ptr() % 16:
        raise ValueError("the residual table must be 16-byte aligned")
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    return n_onsets, n_tiles


def global_v2_blocks_per_sm(layout, device):
    """Resident blocks per SM of K3 v2 (or K3 v2 f64, by the layout's
    ``dtype``) at a ring layout."""

    name = ("qm_migrate_detect_global_v2_f64_blocks_per_sm"
            if global_v2_itemsize(layout.dtype) == 8
            else "qm_migrate_detect_global_v2_blocks_per_sm")
    return blocks_per_sm(name, device, *layout.shape, layout.group,
                         layout.stage_floats, layout.n_stages)


def global_v3_smem(stage_floats, group, stage_passes, n_stages):
    """
    Shared-memory bytes of one K3 v3 f64 block
    (csrc/migrate_detect_global_v3.cu: gw_smem_bytes): ``n_stages`` ring
    stages, each ``stage_floats`` doubles of windows and ``stage_passes``
    x ``group`` residual slices of 128 uint16 (rounded up to 128 bytes),
    the scratch of the item's fold (16 warps x 128 samples of a max and a
    sum of 8 bytes and a 4-byte argmax), ``n_stages`` + 1 mbarriers and
    as many counters (8 bytes each).

    """

    slice_ = GLOBAL_V2_TILE // 2
    stage = round_up(8 * stage_floats + 2 * stage_passes * group * slice_,
                     128)
    return (n_stages * stage + 20 * GLOBAL_V3_WARPS * GLOBAL_V2_SBLK
            + 8 * (2 * n_stages + 2))


def global_v3_layout(layout):
    """
    K3 v3 f64's ring on K3 v2 f64's tables, whose ring ``layout``
    (:func:`global_v2_layout` in float64, shape (16, 8)) fixes each
    window's offset in a stage: a namespace with ``stage_passes`` (2, one
    stage an item, where the layout's one group holds every onset and two
    such stages fit a block; else 1, a stage of G windows and one pass's
    slices, K3 v2 f64's stage), ``npp`` and ``unroll``, its form
    (:data:`GLOBAL_V3_FORM`), the deepest ``n_stages`` of
    :data:`GLOBAL_V2_STAGES` that fits one block an SM and the block's
    ``smem`` bytes; or None where none fits (not on a layout K3 v2 f64
    takes: its stages plus 16 bytes of barriers). Reads nothing from the
    card.

    """

    if layout.dtype != torch.float64 or layout.shape not in \
            GLOBAL_V2_SHAPES_F64:
        raise ValueError(f"K3 v3 f64 takes K3 v2 f64's layout (float64, "
                         f"{tuple(GLOBAL_V2_SHAPES_F64)}), not "
                         f"{layout.dtype} {layout.shape}")
    n_onsets = len(layout.win)
    budget = global_v2_budget(layout.shape, layout.dtype)
    for passes in ((2, 1) if layout.group >= n_onsets else (1,)):
        depths = [n for n in GLOBAL_V2_STAGES if global_v3_smem(
            layout.stage_floats, layout.group, passes, n) <= budget]
        if depths:
            n_stages = max(depths)
            npp, unroll = GLOBAL_V3_FORM[passes]
            return SimpleNamespace(
                stage_passes=passes, npp=npp, unroll=unroll,
                n_stages=n_stages, smem=global_v3_smem(
                    layout.stage_floats, layout.group, passes, n_stages))
    return None


def migrate_detect_global_v3_f64_cuda(onsets_log, base, inv_available, fsmp,
                                      nsamples, tables, max_shift,
                                      form=None):
    """
    Launch K3 v3 f64 (``csrc/migrate_detect_global_v3.cu``) on float64
    tensors on the card: K3 v2 f64's function on K3 v2 f64's ``tables``
    (:func:`global_v2_tables` in float64, built for this ``fsmp``), on a
    persistent ring (:func:`global_v3_layout`) that stages an item (a
    tile x 128 samples) once where one stage holds all its windows.
    Checks as :func:`migrate_detect_global_v2_cuda`, and raises on float32
    tables. ``form`` (one of :data:`GLOBAL_V3_FORMS`) overrides the
    ring's (:data:`GLOBAL_V3_FORM`), for experiments. Returns (tmax, targ
    int32 flat indices, tsum), each [n_tiles, nsamples], tmax and tsum
    float64, asynchronously on the current stream; tmax is K3 v2 f64's
    bit for bit, :func:`combine_brick_tiles` finishes the reduction. The
    plain version is :func:`quakemigrate_torch.ops.migrate.detect_reduce`
    in float64.

    """

    t = tables
    ring = global_v3_layout(t.layout)
    if ring is None:
        raise ValueError("K3 v3 f64's ring of two stages does not fit a "
                         "block's shared memory at this layout")
    npp, unroll = (ring.npp, ring.unroll) if form is None else form
    if (npp, unroll) not in GLOBAL_V3_FORMS:
        raise ValueError(f"K3 v3 f64 is not built for the form {form}")
    n_onsets, n_tiles = _check_global_v2(
        onsets_log, base, inv_available, fsmp, nsamples, t, max_shift,
        ring.smem, f"K3 v3 f64's {ring.n_stages} ring stages")
    device = onsets_log.device
    rows, pitch = row_pitch(onsets_log)
    outs = empty_outputs(n_tiles, nsamples, device, torch.float64)
    launch_kernel(
        "qm_migrate_detect_global_v3_f64", device,
        rows.data_ptr(), pitch, base.data_ptr(), t.res.data_ptr(),
        t.flat.data_ptr(), t.win.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, fsmp, nsamples,
        t.layout.group, t.layout.stage_floats, ring.stage_passes,
        ring.n_stages, npp, unroll,
    )
    launches["migrate_detect_global_v3_f64"] += 1
    return outs


def global_v3_blocks_per_sm(layout, device):
    """Resident blocks per SM of K3 v3 f64 on K3 v2 f64's ring
    ``layout`` (one is what it is built for)."""

    ring = global_v3_layout(layout)
    return blocks_per_sm("qm_migrate_detect_global_v3_f64_blocks_per_sm",
                         device, ring.npp, ring.unroll, layout.group,
                         layout.stage_floats, ring.stage_passes,
                         ring.n_stages)


def ring_shape(plan):
    """The shape M1 ring and M2 ring run for a :class:`DetectPlan`: the
    first of :data:`RING_SHAPES` (K3 v2's float32 route shapes, in their
    order) whose warps x npp divide the plan's tile and whose budget holds
    a ring of two stages of the plan's widest window
    (:func:`global_v2_layout`), else None."""

    for shape in RING_SHAPES:
        if (plan.tile % (shape[0] * shape[1]) == 0
                and global_v2_layout(plan.r_spans, shape, group=1)
                is not None):
            return shape
    return None


def ring_refusal(plan, dtype=torch.float32):
    """
    Why M1 ring and M2 ring cannot take a :class:`DetectPlan` for onsets
    of ``dtype``, in words, or None where they can. In float32 the plan's
    tile must be a multiple of a shape's nodes a pass
    (:data:`RING_SHAPES`), and a ring of two stages of its widest window
    must fit the shape's budget, as for K3 v2 (:func:`global_v2_refusal`;
    about 25,000 samples of residual span). In float64 M1 ring f64 and M2
    ring f64 run on K3 v2 f64's tables, so they take what K3 v2 f64 takes
    (:func:`global_v2_refusal` on float64: tile 256, about 11,800 samples
    of residual span). Reads nothing from the card.

    """

    if global_v2_itemsize(dtype) == 8:
        return global_v2_refusal(plan, dtype)
    per_pass = min(w * n for w, n in RING_SHAPES)
    if plan.tile % per_pass:
        return (f"tile {plan.tile} is not a multiple of the ring's "
                f"{per_pass} nodes a pass")
    if ring_shape(plan) is None:
        shape = max(RING_SHAPES, key=lambda s: s[0] * s[1])
        widest = int(global_v2_widths([plan.r_span])[0])
        smem = global_v2_smem(shape, widest, 1, GLOBAL_V2_STAGES[0])
        return (f"a ring of {GLOBAL_V2_STAGES[0]} stages of one window of "
                f"{widest} floats (residual span {plan.r_span}) needs "
                f"{smem} bytes of shared memory, over the "
                f"{global_v2_budget(shape)} a block may use")
    return None


def build_ring_tables(plan, fsmp, device):
    """The tables M1 ring and M2 ring read on a plan K3 v2 does not run
    (:class:`CudaDetectVPU`'s route): :func:`global_v2_tables` at the ring
    layout of :func:`ring_shape` (the plan's tile), with the build's host
    seconds ``build_s`` and the bytes on the card ``nbytes``. Raises where
    :func:`ring_refusal` refuses the plan."""

    reason = ring_refusal(plan)
    if reason is not None:
        raise ValueError(f"M1 ring and M2 ring cannot take the plan: {reason}")
    t0 = time.perf_counter()
    layout = global_v2_layout(plan.r_spans, ring_shape(plan))
    tables = global_v2_tables(plan, fsmp, device, layout)
    tables.build_s = time.perf_counter() - t0
    tables.nbytes = sum(t.numel() * t.element_size()
                        for t in (tables.res, tables.flat, tables.win))
    return tables


def ring_shapes(dtype=torch.float32):
    """The shapes M1 ring and M2 ring are built for on ``dtype`` and their
    blocks per SM: :data:`RING_SHAPES` in float32,
    :data:`RING_SHAPES_F64` in float64."""

    return RING_SHAPES_F64 if global_v2_itemsize(dtype) == 8 else RING_SHAPES


def ring_chunk(dtype=torch.float32):
    """The window samples a block of M1 ring takes on ``dtype``:
    :data:`RING_CHUNK` (124) in float32, :data:`RING_CHUNK_F64` (128) in
    float64."""

    return RING_CHUNK_F64 if global_v2_itemsize(dtype) == 8 else RING_CHUNK


def ring_stages(layout):
    """The ring depth M1 ring and M2 ring run on a K3 v2 ``layout``. In
    float64 (K3 v2 f64's tables, tiles of :data:`GLOBAL_V2_TILE` nodes)
    no more stages than a block fills when it takes its passes in turn,
    passes x ceil(O / G), and at least 2: the tables' entries depend on
    G, not on the depth, and a stage no load fills only takes shared
    memory (at the Icequake plan, one stage a pass, 2 of K3 v2 f64's 4,
    so two blocks share an SM). In float32 the layout's own depth, the
    one its times were taken at."""

    if global_v2_itemsize(layout.dtype) == 8:
        warps, npp = layout.shape
        passes = GLOBAL_V2_TILE // (warps * npp)
        filled = passes * -(-len(layout.win) // layout.group)
        return min(layout.n_stages, max(GLOBAL_V2_STAGES[0], filled))
    return layout.n_stages


def ring_smem(layout):
    """Shared-memory bytes of one M1 ring or M2 ring block
    (csrc/migrate_marginalise_ring.cu: mr_smem_bytes): K3 v2's ring
    (:func:`global_v2_smem`) at :func:`ring_stages` without its fold
    scratch, in elements of the layout's ``dtype``."""

    warps, npp = layout.shape
    item = global_v2_itemsize(layout.dtype)
    stage = round_up(item * layout.stage_floats
                     + 2 * layout.group * warps * npp, 128)
    n_stages = ring_stages(layout)
    return n_stages * stage + 16 * n_stages


def ring_split(layout, n_onsets):
    """Whether M1 ring and M2 ring put a tile's passes on the grid, one a
    block, for a ring ``layout`` and ``n_onsets``: where one pass alone
    fills the ring (its stages a pass, ceil(O / G), at least the ring's
    depth, :func:`ring_stages`), so a block still overlaps its copies
    with its gather; else each block takes its passes in turn and loads
    the next pass's windows while it gathers this one's, as K3 v2 does. (On the H100, PERF.md section 6: the flat Icequake table's
    1,012 tiles of one stage a pass took 0.094 ms unsplit against
    0.109-0.114 split; F1's 1,080 tiles of six stages a pass 0.68 ms split
    against 0.70.)"""

    return -(-n_onsets // layout.group) >= ring_stages(layout)


def ring_slots(window_length):
    """The k slots a lane of M1 ring holds at this window length, or of
    M2 ring at this scan length (1, 2 or 4): the fewest that cover a
    block's samples, min(window_length, RING_CHUNK), at 32 lanes (M2
    ring's blocks of 128 take 4 beyond 64 samples too; the same in
    float64, whose chunk of 128 needs 4 beyond 64 too)."""

    width = min(window_length, RING_CHUNK)
    return 1 if width <= 32 else 2 if width <= 64 else 4


def _check_ring(onsets_log, base, inv_available, fsmp, nsamples, tables,
                max_shift):
    """The checks of M1 ring's and M2 ring's wrappers: ``tables`` built
    for this ``fsmp`` on a layout of a shape the kernels are built for on
    its ``dtype`` (:func:`ring_shapes`: float32 M1 ring and M2 ring,
    float64 their f64 forms, on K3 v2 f64's tiles), onsets and
    ``inv_available`` of that type, shapes that agree, tensors on one
    device, an onset block long enough for the plan (the device's type is
    checked last, :func:`_check_cuda`). Returns (n_onsets, n_tiles,
    tile)."""

    t = tables
    layout = t.layout
    if t.fsmp != fsmp:
        raise ValueError(f"the tables were built for fsmp {t.fsmp}, not "
                         f"{fsmp}")
    dtype = layout.dtype
    if dtype not in FLOAT_DTYPES or layout.shape not in ring_shapes(dtype):
        raise ValueError(f"M1 ring and M2 ring take float32 layouts of the "
                         f"shapes {tuple(RING_SHAPES)} and float64 layouts "
                         f"of {tuple(RING_SHAPES_F64)}, not {layout.shape} "
                         f"({dtype})")
    if layout.n_stages not in GLOBAL_V2_STAGES:
        raise ValueError(f"n_stages ({layout.n_stages}) must be one of "
                         f"{GLOBAL_V2_STAGES}")
    check_smem(ring_smem(layout), f"the ring's {ring_stages(layout)} "
               f"stages of {layout.group} windows")
    device = onsets_log.device
    for name, x, want in (("onsets_log", onsets_log, dtype),
                          ("base", base, torch.int32),
                          ("inv_available", inv_available, dtype),
                          ("res", t.res, torch.uint16),
                          ("flat", t.flat, torch.int32),
                          ("win", t.win, torch.int32)):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if x.dtype != want or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} tensor")
    n_onsets, t_len = onsets_log.shape
    n_tiles, tile = t.flat.shape
    passes = t.res.shape[1]
    warps, npp = layout.shape
    if (base.shape != (n_tiles, n_onsets)
            or t.res.shape != (n_tiles, passes, n_onsets, warps * npp)
            or passes * warps * npp != tile
            or t.win.shape != (n_onsets, 2)
            or inv_available.numel() != 1):
        raise ValueError(
            f"inconsistent shapes: onsets {tuple(onsets_log.shape)}, base "
            f"{tuple(base.shape)}, res {tuple(t.res.shape)}, flat "
            f"{tuple(t.flat.shape)}, win {tuple(t.win.shape)}, shape "
            f"{layout.shape}")
    if global_v2_itemsize(dtype) == 8 and tile != GLOBAL_V2_TILE:
        raise ValueError(f"M1 ring f64 and M2 ring f64 take K3 v2 f64's "
                         f"tiles of {GLOBAL_V2_TILE} nodes, not {tile}")
    if nsamples < 1 or fsmp < 0:
        raise ValueError(f"bad geometry: fsmp {fsmp}, nsamples {nsamples}")
    _check_onset_length(onsets_log, fsmp, nsamples, max_shift)
    if t.res.data_ptr() % 16:
        raise ValueError("the residual table must be 16-byte aligned")
    return n_onsets, n_tiles, tile


def _check_cuda(device):
    """The last check of M1 ring's and M2 ring's wrappers before the
    launch: raise on a device that is not a CUDA device."""

    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")


def migrate_marginalise_ring_cuda(onsets_log, base, inv_available, fsmp,
                                  nsamples, window_start, window_length,
                                  n_nodes, tables, max_shift, split=None):
    """
    Launch M1 ring (``csrc/migrate_marginalise_ring.cu``) on tensors on
    the card: M1's function (:func:`migrate_marginalise_cuda`), the
    coalescence of every real node of the plan summed over the scan
    samples ``[window_start, window_start + window_length)``, [n_nodes]
    in flat node order (real nodes only are written), through K3 v2's
    ``tables`` of the plan (:func:`global_v2_tables`, built for this
    ``fsmp``; on :class:`CudaDetectVPU`'s route
    :func:`build_ring_tables`), the onset windows streamed through their
    ring. The onsets, ``inv_available`` and the result are of the tables'
    ``layout.dtype``: float32 takes M1 ring, float64 (K3 v2 f64's tables)
    M1 ring f64. A window longer than :func:`ring_chunk` samples (124,
    128 in float64) is split into chunks whose sums are added in chunk
    order; a window of one chunk gives M1's (M1 f64's) result bit for
    bit. The ring is :func:`ring_stages` deep. ``split`` puts the tile's
    passes on the grid (one a block), else each block takes them in turn
    (None: :func:`ring_split` of the tables' layout); the result is the
    same. Raises
    on a window outside the scan, an onset block too short for the plan,
    what the kernel does not take and CPU tensors; the plain version is
    :func:`marginalise_ring_reference`. The launch is asynchronous on the
    current stream.

    """

    n_onsets, n_tiles, tile = _check_ring(onsets_log, base, inv_available,
                                          fsmp, nsamples, tables, max_shift)
    if not (0 <= window_start and 0 <= window_length
            and window_start + window_length <= nsamples):
        raise ValueError(
            f"window [{window_start}, {window_start + window_length}) is not "
            f"inside the {nsamples} scan samples"
        )
    _check_cuda(onsets_log.device)
    layout = tables.layout
    dtype = layout.dtype
    if split is None:
        split = ring_split(layout, n_onsets)
    rows, pitch = row_pitch(onsets_log)
    out = torch.empty(n_nodes, dtype=dtype, device=onsets_log.device)
    n_chunks = max(1, -(-window_length // ring_chunk(dtype)))
    partial = (torch.empty((n_chunks, n_nodes), dtype=dtype,
                           device=onsets_log.device) if n_chunks > 1
               else None)
    launch_kernel(
        typed("qm_migrate_marginalise_ring", dtype), onsets_log.device,
        rows.data_ptr(), pitch, base.data_ptr(), tables.res.data_ptr(),
        tables.flat.data_ptr(), tables.win.data_ptr(),
        inv_available.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), n_chunks, n_nodes,
        n_onsets, n_tiles, tile, fsmp, window_start, window_length,
        layout.group, layout.stage_floats, ring_stages(layout),
        *layout.shape, int(split),
    )
    launches[typed("migrate_marginalise_ring", dtype)] += 1
    return out


def migrate_map_ring_cuda(onsets_log, base, inv_available, fsmp, nsamples,
                          n_nodes, tables, max_shift, split=None):
    """
    Launch M2 ring (``csrc/migrate_marginalise_ring.cu``) on tensors on
    the card: the coalescence map of locate, [n_nodes, nsamples] in flat
    node order (the rows of real nodes written whole), ``map[n, t] =
    exp(inv_available * sum_o L[o, fsmp + tt[n, o] + t])`` each value
    computed as M2's simple form and K3 v2 compute it, so the map equals
    M2 simple bit for bit and its per-sample max K3 v2's tmax; through K3
    v2's ``tables`` of the plan and ``split`` as for
    :func:`migrate_marginalise_ring_cuda`, in the tables' type (float64:
    M2 ring f64 on K3 v2 f64's tables, equal to M2 simple f64 and K3 v2
    f64). Raises on an onset block too short for the plan, what the
    kernel does not take and CPU tensors; the plain version is
    :func:`map_ring_reference`. The launch is asynchronous on the current
    stream.

    """

    n_onsets, n_tiles, tile = _check_ring(onsets_log, base, inv_available,
                                          fsmp, nsamples, tables, max_shift)
    if -(-nsamples // RING_SBLK) > 65535:
        raise ValueError(f"bad geometry: nsamples {nsamples}")
    _check_cuda(onsets_log.device)
    layout = tables.layout
    dtype = layout.dtype
    if split is None:
        split = ring_split(layout, n_onsets)
    rows, pitch = row_pitch(onsets_log)
    out = torch.empty((n_nodes, nsamples), dtype=dtype,
                      device=onsets_log.device)
    launch_kernel(
        typed("qm_migrate_map_ring", dtype), onsets_log.device,
        rows.data_ptr(), pitch, base.data_ptr(), tables.res.data_ptr(),
        tables.flat.data_ptr(), tables.win.data_ptr(),
        inv_available.data_ptr(), out.data_ptr(), n_onsets, n_tiles, tile,
        fsmp, nsamples, layout.group, layout.stage_floats,
        ring_stages(layout), *layout.shape, int(split),
    )
    launches[typed("migrate_map_ring", dtype)] += 1
    return out


def ring_local(tables):
    """Each brick-order node's read offset in onset o's staged window, as
    the ring's tables hold it: the entry less the window's offset in its
    stage, ``((fsmp + base[i, o]) & (unit - 1)) + fine[i, o, n]`` (unit 4
    floats or 2 doubles, :func:`global_v2_unit`); int64 [n_tiles, O,
    tile]."""

    res = tables.res.long()
    n_tiles, passes, n_onsets, slice_ = res.shape
    local = res.permute(0, 2, 1, 3).reshape(n_tiles, n_onsets,
                                            passes * slice_)
    return local - tables.win[:, 0].long().to(res.device)[None, :, None]


def _ring_scatter(values, flat, shape):
    """``values`` [n_tiles, tile, ...] into zeros of ``shape`` at the flat
    indices ``flat`` [n_tiles, tile]; padding (-1) written nowhere."""

    out = torch.zeros(shape, dtype=values.dtype, device=values.device)
    real = flat.reshape(-1) >= 0
    out[flat.reshape(-1)[real].long()] = values.reshape(
        (-1,) + values.shape[2:])[real]
    return out


def marginalise_ring_reference(onsets_log, base, inv_available, fsmp,
                               window_start, window_length, n_nodes, tables,
                               max_elements=2**23):
    """
    Plain PyTorch version of M1 ring (and M1 ring f64, on float64 tables)
    through its ``tables`` (built for this ``fsmp``), in the kernel's
    order: for each chunk c of :func:`ring_chunk` samples of the window
    (124, or 128 in float64), from its first sample d = ``window_start +
    c chunk``, node n reads onset o at column ``((fsmp + base[i, o]) &
    ~(unit - 1)) + (d & ~(unit - 1)) + (d & (unit - 1)) +`` its entry less
    the window's offset (:func:`ring_local`; unit 4 floats or 2 doubles),
    summed in order o = 0..O-1; ``exp(acc * inv_available)``; each lane's
    samples ``lane + 32 k`` (k < :func:`ring_slots`) in k order, then the
    warp's xor tree (lane 0's sum); the chunks added in chunk order;
    scattered through ``flat``. Returns [n_nodes] of the onsets' type,
    zero where no real node writes. Used by the tests and the card's
    holds, not by the main path.

    """

    if tables.fsmp != fsmp:
        raise ValueError(f"the tables were built for fsmp {tables.fsmp}, "
                         f"not {fsmp}")
    local = ring_local(tables).to(onsets_log.device)
    flat = tables.flat.to(onsets_log.device)
    unit = global_v2_unit(tables.layout.dtype)
    step = ring_chunk(tables.layout.dtype)
    lead = ((fsmp + base.long()) & ~(unit - 1))
    n_tiles, tile = flat.shape
    slots = ring_slots(window_length)
    out = None
    for c in range(max(1, -(-window_length // step))):
        d = window_start + c * step
        cw = min(step, window_length - c * step)
        lanes = torch.zeros((n_tiles, tile, 32 * slots),
                            dtype=onsets_log.dtype, device=onsets_log.device)
        if cw > 0:
            for t0, acc in plan_acc_chunks(
                    onsets_log, lead + (d & ~(unit - 1)) + (d & (unit - 1)),
                    local, 0, cw,
                    max_elements):
                lanes[t0:t0 + len(acc), :, :cw] = torch.exp(
                    acc * inv_available)
        lanes = lanes.reshape(n_tiles, tile, slots, 32)
        total = lanes[:, :, 0]
        for k in range(1, slots):
            total = total + lanes[:, :, k]
        lane = torch.arange(32, device=onsets_log.device)
        for x in (16, 8, 4, 2, 1):
            total = total + total[:, :, lane ^ x]
        chunk = _ring_scatter(total[:, :, 0], flat, (n_nodes,))
        out = chunk if out is None else out + chunk
    return out


def map_ring_reference(onsets_log, base, inv_available, fsmp, nsamples,
                       n_nodes, tables, max_elements=2**23):
    """
    Plain PyTorch version of M2 ring (and M2 ring f64, on float64 tables)
    through its ``tables`` (built for this ``fsmp``): node n reads onset
    o at column ``((fsmp + base[i, o]) & ~(unit - 1)) + s0 +`` its entry
    less the window's offset (:func:`ring_local`; unit 4 floats or 2
    doubles) ``+ t`` for the block of 128 samples from s0, summed in order
    o = 0..O-1; ``exp(acc * inv_available)``, the product rounded on its
    own; each real node's row through ``flat``. Returns [n_nodes,
    nsamples] of the onsets' type, zero in rows no real node writes. Used
    by the tests and the card's holds, not by the main path.

    """

    if tables.fsmp != fsmp:
        raise ValueError(f"the tables were built for fsmp {tables.fsmp}, "
                         f"not {fsmp}")
    local = ring_local(tables).to(onsets_log.device)
    flat = tables.flat.to(onsets_log.device)
    values = torch.empty(flat.shape + (nsamples,), dtype=onsets_log.dtype,
                         device=onsets_log.device)
    unit = global_v2_unit(tables.layout.dtype)
    for t0, acc in plan_acc_chunks(onsets_log,
                                   (fsmp + base.long()) & ~(unit - 1),
                                   local, 0, nsamples, max_elements):
        values[t0:t0 + len(acc)] = torch.exp(acc * inv_available)
    return _ring_scatter(values, flat, (n_nodes, nsamples))


def ring_blocks_per_sm(layout, length, map_=False):
    """Resident blocks per SM of M1 ring at a window of ``length``
    samples, or of M2 ring (``map_``) at a scan of ``length`` samples
    (their k slots, :func:`ring_slots`), at a ring layout and the depth
    they run on it (:func:`ring_stages`), in the layout's type, on the
    current device."""

    name = ("qm_migrate_ring_f64_blocks_per_sm"
            if global_v2_itemsize(layout.dtype) == 8
            else "qm_migrate_ring_blocks_per_sm")
    return blocks_per_sm(name,
                         torch.device("cuda", torch.cuda.current_device()),
                         *layout.shape, ring_slots(length), int(map_),
                         layout.group, layout.stage_floats,
                         ring_stages(layout))


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
    tables, and :meth:`map`, locate's map path, M2.

    ``dtype`` is the element type of the prepared onsets and of the
    outputs: float32 here and on :class:`CudaDetectVPU`'s route (other
    types raise: those kernels have no other form); float32 or float64 on
    :class:`CudaDetectGlobal`'s, the route of ``precision="double"``.

    """

    kernel = staticmethod(migrate_detect_v2_cuda)
    # The element types this detector's kernels have a form for
    dtypes = (torch.float32,)

    def __init__(self, traveltimes, node_count, fsmp, nsamples, device,
                 tile=256, brick_shape=(8, 8, 4), plan=None,
                 dtype=torch.float32):
        if dtype not in self.dtypes:
            raise ValueError(f"{type(self).__name__} has no kernel for "
                             f"{dtype} onsets (it takes {self.dtypes})")
        if plan is None:
            plan = DetectPlan(traveltimes, node_count, tile=tile,
                              brick_shape=brick_shape)
        self.plan = plan
        self.dtype = dtype
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
        device: (clipped, logged and masked onsets [O, T], inv_available
        [1]), both of the detector's ``dtype``."""

        if onsets.device != self.device:
            raise ValueError(
                f"onsets are on {onsets.device}, the plan on {self.device}"
            )
        _check_onset_length(
            onsets, self.fsmp, self.nsamples, self._max_shift
        )
        onsets_log = _prepare_onsets(onsets, mask).to(self.dtype)
        inv_available = (
            1.0 / torch.as_tensor(available, dtype=self.dtype,
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

    def map(self, onsets_log, inv_available):
        """M2 on the plan (:func:`migrate_map_v2_cuda`, K1 v2's tables) for
        prepared onsets on the card: the coalescence map f32 [n_nodes,
        nsamples] in flat node order. Raises on CPU tensors and on a plan
        M2 cannot stage."""

        return migrate_map_v2_cuda(
            onsets_log, self.base, self.fine16, self.valid, self.perm,
            inv_available, self.span_off, self.win_floats, self.fsmp,
            self.nsamples, self.n_nodes, self._max_shift,
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
    This is the route of plans that K1 v2, and so M1 v2 and M2, cannot
    stage: :meth:`marginalise` runs M1 ring and :meth:`map` M2 ring on K3
    v2's ring of onset windows, through tables of the plan built at their
    first call (:func:`build_ring_tables`: :attr:`ring`, with its build
    seconds and bytes); where :attr:`ring_refusal` (decided from the plan at
    construction, :func:`ring_refusal`) refuses the plan, M1 and M2's
    simple form on the plan's int32 ``fine``.

    """

    kernel = staticmethod(migrate_detect_vpu_v2_cuda)

    def __init__(self, traveltimes, node_count, fsmp, nsamples, device,
                 tile=512, brick_shape=(8, 8, 8), plan=None,
                 dtype=torch.float32):
        tile = tile if plan is None else plan.tile
        if tile not in VPU_TILES:
            raise ValueError(f"tile ({tile}) must be one of {VPU_TILES}")
        if plan is None:
            plan = DetectPlan(traveltimes, node_count, tile=tile,
                              brick_shape=brick_shape)
        super().__init__(traveltimes, node_count, fsmp, nsamples, device,
                         plan=plan, dtype=dtype)

    def _load(self, plan):
        """K2 v2's tables of the plan, on the device, and its ring depth
        (at least the smallest, with which a plan too wide raises at
        launch); whether M1 ring and M2 ring take the plan (their tables
        wait for the first call)."""

        self.tables = vpu_v2_tables(plan, self.fsmp, self.device)
        self.n_stages = (vpu_v2_stages(plan.tile, plan.r_span)
                         or VPU_V2_STAGES[0])
        self.ring_refusal = ring_refusal(plan, self.dtype)
        self.ring = None

    def ring_tables(self):
        """M1 ring's and M2 ring's tables (:func:`build_ring_tables`),
        built at the first call and kept; None where :attr:`ring_refusal`
        refuses the plan."""

        if self.ring is None and self.ring_refusal is None:
            self.ring = build_ring_tables(self.plan, self.fsmp,
                                          self.device)
        return self.ring

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
        """Locate's pass 2 on the plan for prepared onsets on the card:
        M1 ring (:func:`migrate_marginalise_ring_cuda`) on the ring's
        tables, or M1 (:func:`migrate_marginalise_cuda`, the int32
        residuals ``fine``) where :attr:`ring_refusal` refuses the plan,
        each in the onsets' type (float64 on :class:`CudaDetectGlobal`:
        M1 ring f64, M1 f64): [n_nodes] in flat node order. Raises on CPU
        tensors."""

        ring = self.ring_tables()
        if ring is not None:
            return migrate_marginalise_ring_cuda(
                onsets_log, self.base, inv_available, self.fsmp,
                self.nsamples, window_start, window_length, self.n_nodes,
                ring, self._max_shift)
        return migrate_marginalise_cuda(
            onsets_log, self.base, self.fine, self.valid, self.perm,
            inv_available, self.fsmp, self.nsamples, window_start,
            window_length, self.n_nodes, self._max_shift,
        )

    def map(self, onsets_log, inv_available):
        """Locate's map on the plan for prepared onsets on the card: M2
        ring (:func:`migrate_map_ring_cuda`) on the ring's tables, or M2's
        simple form (:func:`migrate_map_cuda`, the int32 residuals
        ``fine``) where :attr:`ring_refusal` refuses the plan, each in the
        onsets' type (float64: M2 ring f64, M2 simple f64): [n_nodes,
        nsamples] in flat node order. Raises on CPU tensors."""

        ring = self.ring_tables()
        if ring is not None:
            return migrate_map_ring_cuda(
                onsets_log, self.base, inv_available, self.fsmp,
                self.nsamples, self.n_nodes, ring, self._max_shift)
        return migrate_map_cuda(
            onsets_log, self.base, self.fine, self.valid, self.perm,
            inv_available, self.fsmp, self.nsamples, self.n_nodes,
            self._max_shift,
        )

    def plain(self, onsets_log, inv_available):
        return vpu_v2_reference(
            onsets_log, self.base, self.valid, inv_available, self.fsmp,
            self.nsamples, self.tables,
        )


class CudaDetectGlobal(CudaDetect):
    """
    The counterpart of the JAX package's XLA shift-table reduction, for
    the plans no staged kernel takes (:func:`v2_refusal` and
    :func:`vpu_v2_refusal` both refuse) and for ``kernel="xla"``: the
    contract of :class:`CudaDetect`, with ties to the first flat node
    index as on the plain path, through one of two kernels chosen from
    the plan before any launch (:func:`global_v2_refusal`, which
    ``detect_route`` logs):

    - K3 v2 (:func:`migrate_detect_global_v2_cuda`; in float64 K3 v3 f64)
      on every plan whose
      widest window fits a ring of two stages: the plan's BRICK tiles,
      the onset windows streamed through an mbarrier ring
      (:func:`global_v2_layout` at :func:`global_v2_shape`,
      :attr:`layout`); within a tile the fold
      takes the smaller flat index on equal values, and
      :func:`combine_brick_tiles` the smallest flat index among the
      tiles attaining the max;
    - K3 (:func:`migrate_detect_global_cuda`) on wider plans: FLAT tiles
      of :data:`K3_TILE` consecutive nodes of the flat-order
      traveltimes, the onset rows read from global memory, so no
      residual span bounds it; the first flat index within a tile and
      the first tile on equal maxima (:func:`combine_flat_tiles`).

    :attr:`v2_refusal` says why K3 v2 was not taken (None where it was).
    With ``dtype`` float64 (``precision="double"``) every kernel of the
    route is a float64 one: K3 v3 f64
    (:func:`migrate_detect_global_v3_f64_cuda`, the redesign of K3 v2 f64
    on its tables) where K3 v2 f64's ring of doubles holds the plan's
    widest window (:func:`global_v2_refusal` on float64), else K3 f64; for
    locate M1 ring f64 and M2 ring f64 on K3 v2 f64's tables, or M1 f64
    and M2 simple f64 where K3 v2 f64 refuses the plan. :meth:`launch_v2`
    launches K3 v2 (K3 v2 f64 in float64), K3 v3 f64's yardstick.
    :meth:`reduce` on CPU tensors runs the plain version,
    :func:`quakemigrate_torch.ops.migrate.detect_reduce`, and counts no
    launch; :meth:`reduce_log` runs the kernel only. For locate it keeps
    the :class:`DetectPlan` (built once, at any span, for ``plan``
    None): where K3 v2 takes the plan, :meth:`marginalise` is M1 ring and
    :meth:`map` M2 ring (their f64 forms in float64), on K3 v2's own
    tables (:attr:`tables`); elsewhere (:attr:`ring_refusal`: K3 v2's
    reason) M1 and M2's simple form (or their f64 forms), which read the
    onsets from global memory through the plan's int32 ``fine``.

    """

    marginalise = CudaDetectVPU.marginalise
    map = CudaDetectVPU.map
    dtypes = FLOAT_DTYPES

    def __init__(self, traveltimes, node_count, fsmp, nsamples, device,
                 plan=None, dtype=torch.float32):
        super().__init__(traveltimes, node_count, fsmp, nsamples, device,
                         plan=plan, dtype=dtype)
        # K3's flat table: the traveltimes, or on a slab of a plan
        # (``DetectPlan.slab``) the rows of its real nodes, whose flat
        # indices ``rows`` map K3's row indices back to the grid's
        self.rows = None
        if self.plan.nodes is not None:
            rows, traveltimes = self.plan.flat_rows()
            self.rows = self._put(rows)
        self.tt = self._put(np.ascontiguousarray(traveltimes, np.int32))

    def _flat(self, max_coa, max_idx, coa_sum):
        """K3's outputs with its row indices mapped to flat node indices
        (on a slab of a plan)."""

        if self.rows is not None:
            max_idx = self.rows[max_idx.long()].to(torch.int32)
        return max_coa, max_idx, coa_sum

    def _empty(self, dtype, device):
        """The outputs of a slab with no real node, which K3 cannot take:
        coalescence 0, no node (INT32_MAX), as dead tiles give."""

        zeros = torch.zeros(self.nsamples, dtype=dtype, device=device)
        return zeros, torch.full((self.nsamples,), torch.iinfo(
            torch.int32).max, dtype=torch.int32, device=device), zeros

    def _load(self, plan):
        """K3 v2's tables of the plan, for the detector's ``dtype``, where
        it takes the plan (K3 reads the flat table, :attr:`tt`)."""

        self.v2_refusal = global_v2_refusal(plan, self.dtype)
        self.layout = self.tables = None
        if self.v2_refusal is None:
            self.layout = global_v2_layout(
                plan.r_spans, global_v2_shape(plan.r_spans, self.dtype),
                dtype=self.dtype)
            self.tables = global_v2_tables(plan, self.fsmp, self.device,
                                           self.layout)
        # M1 ring and M2 ring (their f64 forms in float64) run on K3 v2's
        # tables, where K3 v2 takes the plan
        self.ring_refusal = self.v2_refusal

    def ring_tables(self):
        """The tables M1 ring and M2 ring read: K3 v2's (:attr:`tables`),
        or None where :attr:`ring_refusal` refuses the plan."""

        return self.tables if self.ring_refusal is None else None

    def reduce(self, onsets, mask, available):
        """(max_coa, max_idx int32, coa_sum), each [nsamples], of one
        window's onsets [O, T]: the kernel on a CUDA device, the plain
        version on the CPU."""

        if onsets.is_cuda:
            return self.reduce_log(*self.prepare(onsets, mask, available))
        if onsets.device != self.device:
            raise ValueError(
                f"onsets are on {onsets.device}, the plan on {self.device}"
            )
        if self.tt.shape[0] == 0:
            return self._empty(onsets.dtype, onsets.device)
        return self._flat(*detect_reduce(
            onsets, self.tt, mask, available, self.fsmp, self.nsamples,
            self.tt.shape[0]))

    def reduce_log(self, onsets_log, inv_available):
        """The kernel and its combine for prepared onsets (:meth:`prepare`)
        on the card; raises on CPU tensors (the plain version takes the
        raw onsets: :meth:`reduce`)."""

        if self.tables is None and self.tt.shape[0] == 0:
            return self._empty(onsets_log.dtype, onsets_log.device)
        parts = self.launch(onsets_log.contiguous(), inv_available)
        self.launches += 1
        if self.tables is None:
            return self._flat(*combine_flat_tiles(*parts))
        return combine_brick_tiles(*parts)

    def launch(self, onsets_log, inv_available):
        """The kernel, for prepared onsets on the card: (tmax, targ flat
        indices, tsum), each [n_tiles, nsamples], on the plan's brick
        tiles (K3 v2; K3 v3 f64 in float64) or on flat tiles (K3, where
        K3 v2 refuses the plan)."""

        if self.tables is None:
            return self.launch_v1(onsets_log, inv_available)
        if self.dtype == torch.float64:
            return migrate_detect_global_v3_f64_cuda(
                onsets_log, self.base, inv_available, self.fsmp,
                self.nsamples, self.tables, self._max_shift)
        return self.launch_v2(onsets_log, inv_available)

    def launch_v2(self, onsets_log, inv_available):
        """K3 v2 (K3 v2 f64 in float64) on the plan's tables, for
        prepared onsets on the card; raises where K3 v2 refuses the
        plan."""

        return migrate_detect_global_v2_cuda(
            onsets_log, self.base, inv_available, self.fsmp, self.nsamples,
            self.tables, self._max_shift)

    def launch_v1(self, onsets_log, inv_available):
        """K3 on the flat table, for prepared onsets on the card: (tmax,
        targ, tsum), each [n_tiles, nsamples] of flat tiles."""

        return migrate_detect_global_cuda(onsets_log, self.tt, inv_available,
                                          self.fsmp, self.nsamples)
