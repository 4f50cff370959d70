# -*- coding: utf-8 -*-
"""
Reference-shaped compute bindings, after the JAX package's
``core/compat.py``.

The reference exposes its C kernels as public Python functions
(``quakemigrate.core.migrate``, ``find_max_coa`` and the three STA/LTA
variants). The port's equivalents live in :mod:`quakemigrate_torch.ops`
with device-native layouts (a flat node axis, fused reductions); these
wrappers re-express them under the reference call signatures, numpy in
and numpy out, the 4-D map layout, so that scripts written against the
reference's core API run unchanged.

``threads`` is accepted for API parity and ignored. ``device`` (default
the card) is where the work runs; ``device="cpu"`` runs the plain
versions.

"""

import numpy as np
import torch

from quakemigrate_torch import util
from quakemigrate_torch.device import resolve_device


@util.timeit()
def migrate(onsets, traveltimes, first_idx, last_idx, available, threads=1,
            device="cuda"):
    """
    Migrate onset functions along integer-sample traveltimes and stack
    into a 4-D coalescence map (the reference's ``core.migrate``).

    On the card the map comes from the detector of the port's detect
    route for these traveltimes (``signal.scan.detect_route``): M2 v2 on
    K1 v2's plan (M2 where M2 v2 refuses it), M2 ring on the K2 v2 and K3
    routes (M2's simple form where the ring refuses the plan); on the CPU
    from the plain ``ops.migrate.migrate_map``. Traveltimes are clipped
    to ``[0, last_idx]``, as the reference and the JAX package clip them,
    so the kernels never read past an onset row. The map is float32 on
    either device and returned as float64, as the JAX package returns it.

    Parameters
    ----------
    onsets : array, shape (n_onsets, t_samples)
        Raw (un-logged) onset functions; clipped to >= 0.01 and logged
        internally, as in the reference binding.
    traveltimes : int array, shape (nx, ny, nz, n_onsets)
        Traveltimes as integer multiples of the sampling rate.
    first_idx, last_idx : int
        Pre-/post-pad sample counts trimmed from the scan range.
    available : int
        Number of available onset functions (the stack divisor).
    threads : int, optional
        Accepted for reference API parity; ignored.
    device : str or torch.device, optional
        Where to migrate (default "cuda").

    Returns
    -------
    map4d : float64 array, shape (nx, ny, nz, t_samples - first_idx - last_idx)

    """

    from quakemigrate_torch.ops.migrate import migrate_map

    onsets = np.asarray(onsets)
    traveltimes = np.asarray(traveltimes)
    *grid_dims, n_luts = traveltimes.shape
    n_onsets, t_samples = onsets.shape
    n_samples = int(t_samples - first_idx - last_idx)

    if n_luts != n_onsets:
        raise ValueError(
            "Mismatch between number of stations for data and LUT, "
            f"{n_onsets}:{n_luts}"
        )
    if onsets.size < n_samples + first_idx:
        raise ValueError("Data array smaller than coalescence array.")

    device = resolve_device(device)
    tt_flat = np.ascontiguousarray(np.clip(
        traveltimes.reshape(-1, n_onsets), 0, t_samples - first_idx
        - n_samples).astype(np.int32))
    block = torch.from_numpy(onsets.astype(np.float32)).to(device)
    mask = torch.ones(n_onsets, dtype=torch.float32, device=device)
    if device.type == "cpu":
        map_flat = migrate_map(block, torch.from_numpy(tt_flat), mask,
                               float(available), int(first_idx), n_samples)
    else:
        from quakemigrate_torch.signal.scan import (
            detect_route,
            route_detector,
        )

        node_count = tuple(grid_dims) + (1,) * (3 - len(grid_dims))
        route, _, plan = detect_route(tt_flat, node_count, device)
        detector = route_detector(route, plan, tt_flat, node_count,
                                  int(first_idx), n_samples, device)
        map_flat = detector.map(*detector.prepare(block, mask, available))
    return np.asarray(map_flat.cpu(), dtype=np.float64).reshape(
        tuple(grid_dims) + (n_samples,)
    )


@util.timeit()
def find_max_coa(map4d, threads=1, device="cuda"):
    """
    Per-sample max / normalised max / argmax over the grid of a 4-D
    coalescence map (the reference's ``core.find_max_coa``), through
    ``ops.migrate.find_max_coa`` on ``device``.

    Returns ``(max_coa f64[n], max_norm_coa f64[n], max_coa_idx i64[n])``
    with flat (C-order) node indices, like the reference. The map is cast
    to float32 first, as the JAX package casts it, and ties go to the
    first flat index; so a near-degenerate map can tie, and pick the
    first of its nodes, where the reference's float64 binding would tell
    them apart.

    """

    from quakemigrate_torch.ops.migrate import find_max_coa as _find_max_coa

    map4d = np.asarray(map4d)
    *grid_dims, n_samples = map4d.shape
    n_nodes = int(np.prod(grid_dims))
    flat = torch.from_numpy(np.ascontiguousarray(
        map4d.reshape(n_nodes, n_samples), dtype=np.float32))
    max_coa, max_norm_coa, max_idx = _find_max_coa(
        flat.to(resolve_device(device)))
    return (
        np.asarray(max_coa.cpu(), dtype=np.float64),
        np.asarray(max_norm_coa.cpu(), dtype=np.float64),
        np.asarray(max_idx.cpu(), dtype=np.int64),
    )


def _stalta(kind, signal, nsta, nlta, device):
    from quakemigrate_torch.ops import stalta as _s

    signal = torch.from_numpy(np.ascontiguousarray(signal, dtype=np.float32))
    onset = getattr(_s, kind)(signal.to(resolve_device(device)), int(nsta),
                              int(nlta))
    return np.asarray(onset.cpu(), dtype=np.float64)


def overlapping_sta_lta(signal, nsta, nlta, device="cuda"):
    """Classic STA/LTA, the STA at the trailing end of the LTA window (the
    reference's ``core.overlapping_sta_lta``)."""

    return _stalta("overlapping_sta_lta", signal, nsta, nlta, device)


def centred_sta_lta(signal, nsta, nlta, device="cuda"):
    """Centred STA/LTA, the STA window after the LTA window (the
    reference's ``core.centred_sta_lta``)."""

    return _stalta("centred_sta_lta", signal, nsta, nlta, device)


def recursive_sta_lta(signal, nsta, nlta, device="cuda"):
    """Recursive (exponential-decay) STA/LTA (the reference's
    ``core.recursive_sta_lta``): R1 on the card, its plain version on the
    CPU."""

    return _stalta("recursive_sta_lta", signal, nsta, nlta, device)
