# -*- coding: utf-8 -*-
"""
quakemigrate_torch.lut -- traveltime lookup tables (:class:`LUT`, the
builders from homogeneous, 1-D and 3-D velocity models, the NonLinLoc
grid reader, the port's npz+json file format, the carry-over of a JAX
lookup table's state) and the traveltime state the detect path
migrates with: the node-major sample-offset table, and the mapping of
flat node indices back to grid indices.

"""

import numpy as np

from .lut import LUT, Grid3D, StationTable  # noqa: F401
from .create import (  # noqa: F401
    compute_traveltimes,
    lut_from_reference,
    read_nlloc,
)


def traveltime_table(tables, scan_rate):
    """
    Per-slot traveltime grids (seconds; numpy arrays, one per canonical
    (phase, station) slot, phase-major, as ``lut[station][phase]``) ->
    node-major int32 sample offsets [n_nodes, n_slots], as the JAX
    ``QuakeScan._build_device_state`` builds them: ``rint(t * rate)``,
    raveled in C order.

    """

    return np.stack(
        [np.rint(t * scan_rate).astype(np.int32).ravel() for t in tables],
        axis=-1,
    )


def unravel(max_idx, node_count):
    """Flat node indices [S] -> grid indices (i, j, k) [S, 3]."""

    return np.column_stack(np.unravel_index(np.asarray(max_idx), node_count))
