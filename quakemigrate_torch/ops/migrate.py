# -*- coding: utf-8 -*-
"""
Migration and coalescence reduction in plain PyTorch: the flat-order
definitions that the CUDA kernels (ops.cuda_migrate) are held against,
and the path a CPU tensor takes: the fused detect reduction, the full
coalescence map of locate and its marginalisation over a window.

Counterpart of quakemigrate_tpu.ops.migrate. The onsets are clipped and
logged, so the geometric-mean stack is the exp of a masked mean of logs.
Each node reads ``log_onset[o, fsmp + tt[n, o] + t]`` directly by
indexing the onset rows; no shifted-window table is built.

Tie-breaking: the FIRST flat node index that attains the maximum wins,
within a tile (argmax) and across tiles (a strict ``>``).

"""

import torch

# Node-tile size of the plain reduction: bounds the [tile, S] working set.
DEFAULT_TILE = 4096

MIN_ONSET_CLIP = 0.01


def _prepare_onsets(onsets, mask):
    """Clip, log, and zero-out masked onset rows."""

    return torch.log(torch.clamp(onsets, min=MIN_ONSET_CLIP)) * mask[:, None]


def _stack_tile(onsets_log, tt_tile, available, fsmp, nsamples):
    """
    Coalescence of one node tile, [Nt, nsamples]:
    ``exp(sum_o onsets_log[o, fsmp + tt[n, o] + t] / available)``.
    Onsets are summed in order o = 0..O-1. Traveltimes are clipped to
    the block, ``[0, T - fsmp - nsamples]``.

    """

    d_max = onsets_log.shape[-1] - fsmp - nsamples
    t = torch.arange(nsamples, device=onsets_log.device)
    cols = fsmp + torch.clamp(tt_tile.long(), 0, d_max)
    acc = torch.zeros(
        (tt_tile.shape[0], nsamples), dtype=onsets_log.dtype,
        device=onsets_log.device,
    )
    for o in range(onsets_log.shape[0]):
        acc = acc + onsets_log[o][cols[:, o, None] + t]
    return torch.exp(acc / available)


def detect_reduce(
    onsets, traveltimes, mask, available, fsmp, nsamples, n_nodes_real,
    tile=DEFAULT_TILE, node_offset=0,
):
    """
    Fused migrate + grid reduction over a (possibly padded) node slab.

    ``node_offset`` is the global flat index of this slab's first node;
    nodes whose global index is >= ``n_nodes_real`` are padding and are
    excluded from the max and the sum.

    Returns (max_coa [S], max_idx [S] int32 global indices, coa_sum [S]).

    """

    n_total = traveltimes.shape[0]
    onsets_log = _prepare_onsets(onsets, mask)
    dtype, device = onsets_log.dtype, onsets_log.device
    n_tiles = -(-n_total // tile)
    pad = n_tiles * tile - n_total
    if pad:
        traveltimes = torch.cat([
            traveltimes,
            torch.zeros((pad, traveltimes.shape[1]), dtype=traveltimes.dtype,
                        device=traveltimes.device),
        ])

    node_idx_base = torch.arange(tile, dtype=torch.int32, device=device)
    running_max = torch.full((nsamples,), -torch.inf, dtype=dtype,
                             device=device)
    running_idx = torch.zeros(nsamples, dtype=torch.int32, device=device)
    running_sum = torch.zeros(nsamples, dtype=dtype, device=device)
    for tile_i in range(n_tiles):
        tt_tile = traveltimes[tile_i * tile:(tile_i + 1) * tile]
        coa = _stack_tile(onsets_log, tt_tile, available, fsmp, nsamples)
        local_idx = tile_i * tile + node_idx_base
        global_idx = node_offset + local_idx
        # The tile padding of THIS slab is invalid even where its global
        # index falls below n_nodes_real (a mid-grid slab)
        valid = ((local_idx < n_total) & (global_idx < n_nodes_real))[:, None]
        coa = torch.where(valid, coa, 0.0)
        tile_max = torch.amax(coa, dim=0)
        tile_arg = global_idx[torch.argmax(coa, dim=0)]
        better = tile_max > running_max  # strict: earlier tile wins ties
        running_max = torch.where(better, tile_max, running_max)
        running_idx = torch.where(better, tile_arg, running_idx)
        running_sum = running_sum + torch.sum(coa, dim=0)
    return running_max, running_idx, running_sum


def migrate_detect(
    onsets, traveltimes, mask, available, fsmp, nsamples,
    n_nodes_real=None, tile=DEFAULT_TILE,
):
    """
    Fused migrate + find_max_coa for the detect stage.

    Parameters
    ----------
    onsets : [O, T] float tensor
        Raw (positive) onset functions; clip and log happen here.
    traveltimes : [N, O] int32 tensor
        Traveltime sample offsets, node-major. N may include trailing
        padding rows (excluded via ``n_nodes_real``).
    mask : [O] float tensor
        1.0 for live onset rows, 0.0 for padding.
    available : float or 0-dim tensor
        Number of live onsets (the geometric-mean divisor).
    fsmp, nsamples : int
        First scan sample and number of scan samples; T >= fsmp + S.
    n_nodes_real : int, optional
        Number of real (non-padding) nodes. Defaults to N.

    Returns
    -------
    (max_coa [S], max_coa * n_nodes / coa_sum [S], max_idx [S] int32).

    """

    n_real = traveltimes.shape[0] if n_nodes_real is None else n_nodes_real
    max_coa, max_idx, coa_sum = detect_reduce(
        onsets, traveltimes, mask, available, fsmp, nsamples, n_real, tile
    )
    return max_coa, max_coa * n_real / coa_sum, max_idx


def migrate_detect_batch(
    onsets, traveltimes, mask, available, fsmp, nsamples,
    n_nodes_real=None, tile=DEFAULT_TILE,
):
    """
    :func:`migrate_detect` over a batch of independent scan windows:
    ``onsets`` [B, O, T], ``mask`` [B, O], ``available`` [B]; the
    traveltime table is shared. Returns per-window [B, S] outputs, one
    window at a time, so each equals its own :func:`migrate_detect`.

    """

    n_real = traveltimes.shape[0] if n_nodes_real is None else n_nodes_real
    max_coa, max_idx, coa_sum = (torch.stack(part) for part in zip(*(
        detect_reduce(o, traveltimes, m, a, fsmp, nsamples, n_real, tile)
        for o, m, a in zip(onsets, mask, available))))
    return max_coa, max_coa * n_real / coa_sum, max_idx


def migrate_map(
    onsets, traveltimes, mask, available, fsmp, nsamples, tile=DEFAULT_TILE
):
    """
    Migration retaining the full coalescence map (locate's map path):
    ``map4d_flat [N, nsamples]``, the coalescence of every node (flat
    order) at every scan sample, the flat-node form of the reference's
    map4d (nx, ny, nz, S). The plain version of the CUDA kernel M2
    (``ops.cuda_migrate.migrate_map_v2_cuda``, its simple form
    ``migrate_map_cuda`` and M2 ring ``migrate_map_ring_cuda``) and the
    CPU path of locate's map.

    Onsets are summed in order o = 0..O-1; traveltimes are clipped to the
    block, ``[0, T - fsmp - nsamples]``, as the reference clips them.

    """

    onsets_log = _prepare_onsets(onsets, mask)
    return torch.cat([
        _stack_tile(onsets_log, traveltimes[t0:t0 + tile], available, fsmp,
                    nsamples)
        for t0 in range(0, traveltimes.shape[0], tile)
    ])


def migrate_marginalise(
    onsets, traveltimes, mask, available, fsmp, nsamples, window_start,
    window_length, tile=DEFAULT_TILE,
):
    """
    Migration marginalised over a time window, without materialising the
    4-D map: ``coa_3d_flat [N]`` = the sum over the scan samples
    ``[window_start, window_start + window_length)`` of the coalescence,
    in flat node order. The plain version of the CUDA kernels
    (``ops.cuda_migrate.migrate_marginalise_cuda`` and its redesigns) and
    the CPU path of locate's second pass.

    Only the window's samples are gathered. Traveltimes are clipped to
    the full scan's block, ``[0, T - fsmp - nsamples]``, as the reference
    clips them; onsets are summed in order o = 0..O-1, then the samples.

    """

    if not (0 <= window_start and 0 <= window_length
            and window_start + window_length <= nsamples):
        raise ValueError(
            f"window [{window_start}, {window_start + window_length}) is not "
            f"inside the {nsamples} scan samples"
        )
    onsets_log = _prepare_onsets(onsets, mask)
    d_max = onsets_log.shape[-1] - fsmp - nsamples
    t = torch.arange(window_length, device=onsets_log.device)
    sums = []
    for t0 in range(0, traveltimes.shape[0], tile):
        cols = (fsmp + window_start
                + torch.clamp(traveltimes[t0:t0 + tile].long(), 0, d_max))
        acc = torch.zeros((cols.shape[0], window_length),
                          dtype=onsets_log.dtype, device=onsets_log.device)
        for o in range(onsets_log.shape[0]):
            acc = acc + onsets_log[o][cols[:, o, None] + t]
        sums.append(torch.sum(torch.exp(acc / available), dim=1))
    return torch.cat(sums)


def find_max_coa(map4d_flat, n_nodes_real=None, node_offset=0):
    """
    Per-sample max / normalised max / argmax over the node axis of a
    flattened coalescence map [N, S]: three torch reductions, on the card
    for a map on the card, as the JAX package computes them with plain
    XLA outside any kernel. ``torch.argmax`` returns the FIRST flat node
    index attaining the max, the XLA path's tie rule; the detect kernels
    break ties in their plan's brick order instead (ops.cuda_migrate).

    """

    n_real = map4d_flat.shape[0] if n_nodes_real is None else n_nodes_real
    data = map4d_flat[:n_real]
    max_coa = torch.amax(data, dim=0)
    max_idx = torch.argmax(data, dim=0).to(torch.int32) + node_offset
    coa_sum = torch.sum(data, dim=0)
    return max_coa, max_coa * n_real / coa_sum, max_idx
