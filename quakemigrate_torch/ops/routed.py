# -*- coding: utf-8 -*-
"""
The JAX package's public device functions of migration
(``quakemigrate_tpu.ops``: ``detect_reduce``, ``migrate_detect``,
``migrate_detect_batch``, ``migrate_map``, ``find_max_coa``) on flat
``[N, O]`` traveltime tables, routed by the onsets' device:

- CPU tensors run the plain versions (:mod:`.migrate`), which this module
  calls through that module, so they are the same functions;
- CUDA tensors run the hand kernels of the "k3" route, whose contract is
  the JAX ``detect_reduce``'s (ties to the first flat index):
  :class:`~quakemigrate_torch.ops.cuda_migrate.CudaDetectGlobal`, K3 v2
  where its ring holds the table's widest window, else K3, and their
  float64 forms on float64 onsets; ``migrate_map`` runs M2 ring on K3
  v2's tables of the same detector, M2 ring f64 on K3 v2 f64's on float64
  onsets (M2's simple form, or M2 simple f64, where K3 v2 or K3 v2 f64
  refuses the table). A build or launch failure raises: no plain version
  runs on CUDA tensors.

The kernels take the table as a grid of ``(N, 1, 1)`` nodes, tiled in
runs of 256 consecutive flat nodes. Their plan is host work, so the
detector is built once per table and scan geometry and cached on the
table tensor's identity (its storage pointer, shape, strides and
version counter; the cache holds the tensor, so the pointer cannot be
reused while the entry lives). Traveltimes are clamped to ``[0, T -
fsmp - nsamples]`` when the plan is built, as the plain versions clamp
them. ``n_nodes_real`` and ``node_offset`` mean what they mean in the
JAX functions: rows whose global index ``node_offset + row`` is at or
past ``n_nodes_real`` are padding, excluded from the max and the sum,
and the indices returned are global. ``tile``, the JAX functions' node
tile, is taken and changes no result.

``find_max_coa`` is three torch reductions on either device, as the JAX
package computes it with plain XLA outside any kernel.

"""

from collections import OrderedDict

import torch

from . import migrate as plain
from .migrate import DEFAULT_TILE, find_max_coa  # noqa: F401
from .stalta import signal_transform  # noqa: F401

# Detectors kept, least recently used first out
CACHE_SIZE = 4
_detectors = OrderedDict()


def clear_cache():
    """Drop every cached detector (and the card memory of its plan)."""

    _detectors.clear()


def _check_tile(tile):
    if int(tile) < 1:
        raise ValueError(f"tile ({tile}) must be a positive node count")


def detector(traveltimes, n_rows, t_len, fsmp, nsamples, dtype, device):
    """
    The :class:`~quakemigrate_torch.ops.cuda_migrate.CudaDetectGlobal` of
    the first ``n_rows`` rows of the flat table ``traveltimes`` [N, O],
    clamped to ``[0, t_len - fsmp - nsamples]``, for scans of ``nsamples``
    from ``fsmp`` in onsets of ``dtype`` on ``device``: built on first use,
    then taken from the cache while the table is unchanged.

    """

    from .cuda_migrate import GLOBAL_V2_TILE, CudaDetectGlobal, DetectPlan

    d_max = t_len - fsmp - nsamples
    key = (traveltimes.data_ptr(), tuple(traveltimes.shape),
           traveltimes.stride(), traveltimes._version,
           str(traveltimes.device), n_rows, d_max, fsmp, nsamples, dtype,
           str(device))
    entry = _detectors.get(key)
    if entry is not None:
        _detectors.move_to_end(key)
        return entry[1]
    table = torch.clamp(traveltimes[:n_rows].detach().to("cpu", torch.int32),
                        0, max(d_max, 0)).numpy()
    grid = (n_rows, 1, 1)
    plan = DetectPlan(table, grid, tile=GLOBAL_V2_TILE,
                      brick_shape=(GLOBAL_V2_TILE, 1, 1))
    found = CudaDetectGlobal(table, grid, fsmp, nsamples, device, plan=plan,
                             dtype=dtype)
    _detectors[key] = (traveltimes, found)
    while len(_detectors) > CACHE_SIZE:
        _detectors.popitem(last=False)
    return found


def _check_geometry(onsets, fsmp, nsamples):
    if fsmp < 0 or nsamples < 1 or onsets.shape[-1] < fsmp + nsamples:
        raise ValueError(f"bad geometry: fsmp {fsmp}, nsamples {nsamples}, "
                         f"{onsets.shape[-1]} onset samples")


def detect_reduce(
    onsets, traveltimes, mask, available, fsmp, nsamples, n_nodes_real,
    tile=DEFAULT_TILE, node_offset=0,
):
    """
    Fused migrate + grid reduction over a (possibly padded) node slab of
    the flat table ``traveltimes`` [N, O]; ``node_offset`` is the global
    flat index of the slab's first row, and rows at or past
    ``n_nodes_real`` globally are padding. Returns (max_coa [S], max_idx
    [S] int32 global indices, coa_sum [S]) in the onsets' type: on CUDA
    onsets from the "k3" route's kernel, else from the plain
    :func:`quakemigrate_torch.ops.migrate.detect_reduce`.

    """

    _check_tile(tile)
    if not onsets.is_cuda:
        return plain.detect_reduce(onsets, traveltimes, mask, available,
                                   fsmp, nsamples, n_nodes_real, tile,
                                   node_offset)
    fsmp, nsamples, node_offset = int(fsmp), int(nsamples), int(node_offset)
    _check_geometry(onsets, fsmp, nsamples)
    n_total = traveltimes.shape[0]
    n_rows = min(max(int(n_nodes_real) - node_offset, 0), n_total)
    if n_rows == 0:
        # No real row: the plain versions' result, every coalescence 0
        def full(value, dtype):
            return torch.full((nsamples,), value, dtype=dtype,
                              device=onsets.device)
        return (full(0.0 if n_total else -torch.inf, onsets.dtype),
                full(node_offset if n_total else 0, torch.int32),
                full(0.0, onsets.dtype))
    found = detector(traveltimes, n_rows, onsets.shape[-1], fsmp, nsamples,
                     onsets.dtype, onsets.device)
    max_coa, max_idx, coa_sum = found.reduce(onsets, mask, available)
    return max_coa, max_idx + node_offset, coa_sum


def migrate_detect(
    onsets, traveltimes, mask, available, fsmp, nsamples,
    n_nodes_real=None, tile=DEFAULT_TILE,
):
    """
    Fused migrate + find_max_coa for the detect stage, on the flat table
    ``traveltimes`` [N, O] (rows past ``n_nodes_real`` are padding):
    (max_coa [S], max_coa * n_nodes_real / coa_sum [S], max_idx [S]
    int32), through :func:`detect_reduce`'s route.

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
    ``onsets`` [B, O, T], ``mask`` [B, O], ``available`` [B]; the table is
    shared. Returns per-window [B, S] outputs, each window's equal to its
    own :func:`migrate_detect` call (on the card the detector is built
    once for the batch).

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
    Migration retaining the full coalescence map, ``map4d_flat`` [N, S] in
    flat node order and the onsets' type: on CUDA onsets M2 ring (M2 ring
    f64 on float64 onsets; M2's simple form or its f64 form where
    :attr:`CudaDetectGlobal.ring_refusal` refuses the table) on the "k3"
    route's detector, else the plain
    :func:`quakemigrate_torch.ops.migrate.migrate_map`.

    """

    _check_tile(tile)
    if not onsets.is_cuda:
        return plain.migrate_map(onsets, traveltimes, mask, available, fsmp,
                                 nsamples, tile)
    fsmp, nsamples = int(fsmp), int(nsamples)
    _check_geometry(onsets, fsmp, nsamples)
    found = detector(traveltimes, traveltimes.shape[0], onsets.shape[-1],
                     fsmp, nsamples, onsets.dtype, onsets.device)
    return found.map(*found.prepare(onsets, mask, available))
