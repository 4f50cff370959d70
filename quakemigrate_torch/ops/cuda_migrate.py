# -*- coding: utf-8 -*-
"""
Fused migrate-and-reduce on the GPU: the node-tile plan, the wrappers of
the CUDA kernels ``csrc/migrate_detect.cu`` (K1),
``csrc/migrate_detect_v2.cu`` (K1 v2, the same contract redesigned for
the card's shared-memory pipe) and ``csrc/migrate_detect_vpu.cu`` (K2),
their plain PyTorch version, and the cross-tile combine.

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

# Largest residual span of the int16 residual table ``DetectPlan.fine16``
FINE16_MAX_SPAN = np.iinfo(np.int16).max

# Launches of K1 and K1 v2, counted by their wrappers where they launch
launches = {"migrate_detect": 0, "migrate_detect_v2": 0}


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
      the table of K1 v2 (``csrc/migrate_detect_v2.cu``); a plan whose
      ``r_span`` exceeds ``FINE16_MAX_SPAN`` raises;
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
        if self.r_span > FINE16_MAX_SPAN:
            raise ValueError(
                f"residual span {self.r_span} exceeds {FINE16_MAX_SPAN}, the "
                "limit of the int16 residual table fine16; use smaller bricks"
            )
        self.fine16 = np.ascontiguousarray(fine, np.int16)
        self.span_off = span_offsets(self.r_spans)
        self.win_floats = int(self.span_off[-1])
        self.max_shift = int(tt_perm.max())
        r_max = self.r_span - 1
        self.bits = max(1, int(np.ceil(np.log2(r_max + 1)))) if r_max else 1
        self.r_pow2 = 1 << self.bits


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
                      node_major=False):
    """
    Checks shared by the kernel wrappers: the kernels' dtypes, contiguity,
    plan shapes that agree, and CUDA tensors on one device. ``fine`` is
    the int32 [n_tiles, O, tile] table, or with ``node_major`` the int16
    [n_tiles, tile, O] table ``DetectPlan.fine16``. Raises on what the
    kernels do not take. Returns (n_onsets, t_len, n_tiles, tile).

    """

    device = onsets_log.device
    fine_dtype = torch.int16 if node_major else torch.int32
    expected = (
        ("onsets_log", onsets_log, torch.float32, 2),
        ("base", base, torch.int32, 2),
        ("fine", fine, fine_dtype, 3),
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


def check_smem(smem, what):
    """Raise when one block would need more shared memory than Hopper
    gives it."""

    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{what} need {smem} bytes of shared memory, over the "
            f"{SMEM_LIMIT} a block may use; use a smaller tile or brick"
        )


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


def v2_smem(n_onsets, tile, win_floats):
    """
    Shared-memory bytes of one K1 v2 block (``csrc/migrate_detect_v2.cu``):
    the window offsets (O + 1 ints, rounded up to 4), ``valid`` (tile
    floats), and the larger of the uint16 slab (tile x O rounded up to 8)
    with the ``win_floats`` floats of windows, and the block reduction
    that reuses them. Raises when a block cannot have that much.

    """

    body = max(2 * tile * round_up(n_onsets, 8) + 4 * win_floats,
               4 * 3 * NWARPS * SBLK)
    smem = 4 * (round_up(n_onsets + 1, 4) + tile) + body
    check_smem(smem, f"the residual slab ({tile} x {n_onsets}) and windows "
                     f"({win_floats} floats)")
    return smem


def launch_v2(entry, onsets_log, base, fine16, valid, inv_available, fsmp,
              nsamples, span_off, win_floats, *extra):
    """
    Check and launch ``entry``, K1 v2 (``qm_migrate_detect_v2``) or its
    ablations (``extra`` = the variant), on tensors on the card. Returns
    (tmax f32, targ int32, tsum f32), each [n_tiles, nsamples].

    """

    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine16, valid, inv_available, node_major=True
    )
    if tile % (2 * NWARPS):
        raise ValueError(f"tile ({tile}) must be a multiple of {2 * NWARPS}")
    if nsamples < 1:
        raise ValueError(f"bad geometry: nsamples {nsamples}")
    if (span_off.device != onsets_log.device or span_off.dtype != torch.int32
            or span_off.shape != (n_onsets + 1,)
            or not span_off.is_contiguous()):
        raise ValueError(
            f"span_off must be a contiguous int32 [{n_onsets + 1}] tensor "
            f"on {onsets_log.device}"
        )
    if win_floats < n_onsets * (SBLK + 1):
        raise ValueError(f"win_floats ({win_floats}) is too small")
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
    return outs


class CudaDetect:
    """
    Fused migrate-and-reduce for one (traveltimes, scan geometry), built
    once and called per window like ``PallasDetectMXU``:
    ``__call__(onsets [O, T], mask [O], available)`` returns
    (max_coa, max_idx int32, coa_sum), each [nsamples]; the caller
    normalises.

    The plan lives on ``device``. For onsets on a CUDA device the CUDA
    kernel runs, K1 v2 (:func:`migrate_detect_v2_cuda`), and ``launches``
    counts it; for onsets on the CPU the plain version
    (:func:`detect_reduce_plan_reference`) runs.

    """

    kernel = staticmethod(migrate_detect_v2_cuda)

    def __init__(self, traveltimes, node_count, fsmp, nsamples, device,
                 tile=256, brick_shape=(8, 8, 4)):
        plan = DetectPlan(traveltimes, node_count, tile=tile,
                          brick_shape=brick_shape)
        self.device = resolve_device(device)
        self.fsmp = int(fsmp)
        self.nsamples = int(nsamples)
        self.tile = plan.tile
        self.n_nodes = plan.n_nodes
        self.r_span = plan.r_span
        self._max_shift = plan.max_shift

        def put(a):
            return torch.from_numpy(a).to(self.device)

        self.base = put(plan.base)
        self.fine = put(plan.fine)
        self.fine16 = put(plan.fine16)
        self.span_off = put(plan.span_off)
        self.win_floats = plan.win_floats
        self.valid = put(plan.valid)
        self.perm = put(plan.perm)
        self.launches = 0

    def __call__(self, onsets, mask, available):
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
        if onsets_log.is_cuda:
            parts = self.launch(onsets_log.contiguous(), inv_available)
            self.launches += 1
        else:
            parts = detect_reduce_plan_reference(
                onsets_log, self.base, self.fine, self.valid,
                inv_available, self.fsmp, self.nsamples,
            )
        return combine_tiles(*parts, self.perm, self.tile)

    def launch(self, onsets_log, inv_available):
        """``kernel`` on the plan, for prepared onsets on the card:
        (tmax, targ, tsum), each [n_tiles, nsamples]."""

        return self.kernel(
            onsets_log, self.base, self.fine16, self.valid, inv_available,
            self.fsmp, self.nsamples, self.span_off, self.win_floats,
        )


class CudaDetectVPU(CudaDetect):
    """
    The counterpart of ``PallasDetect`` (the TPU VPU kernel's wrapper):
    the same plan and contract as :class:`CudaDetect` with the VPU plan's
    defaults (tile 512, bricks 8 x 8 x 8) and the kernel
    :func:`migrate_detect_vpu_cuda`. ``__call__(onsets, mask, available)``
    returns ``(max_coa, max_coa_n, max_idx)`` like ``PallasDetect``, with
    ``max_coa_n = max_coa * n_nodes / coa_sum``. CPU onsets take the
    plain version (:func:`detect_reduce_plan_reference`) and count no
    launch.

    """

    kernel = staticmethod(migrate_detect_vpu_cuda)

    def __init__(self, traveltimes, node_count, fsmp, nsamples, device,
                 tile=512, brick_shape=(8, 8, 8)):
        if tile not in VPU_TILES:
            raise ValueError(f"tile ({tile}) must be one of {VPU_TILES}")
        super().__init__(traveltimes, node_count, fsmp, nsamples, device,
                         tile=tile, brick_shape=brick_shape)

    def __call__(self, onsets, mask, available):
        max_coa, max_idx, coa_sum = super().__call__(onsets, mask, available)
        return max_coa, max_coa * self.n_nodes / coa_sum, max_idx

    def launch(self, onsets_log, inv_available):
        return self.kernel(
            onsets_log, self.base, self.fine, self.valid, inv_available,
            self.fsmp, self.nsamples, self.r_span,
        )
