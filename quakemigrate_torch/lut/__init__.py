# -*- coding: utf-8 -*-
"""
quakemigrate_torch.lut -- traveltime lookup tables (:class:`LUT`, the
builders from homogeneous, 1-D and 3-D velocity models, the NonLinLoc
grid reader, the port's npz+json file format, the carry-over of a JAX
lookup table's state, the conversion of old-format pickled tables) and
the traveltime state the detect path migrates with: the node-major
sample-offset table, and the mapping of flat node indices back to grid
indices.

"""

import pickle

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


class _OldLUTUnpickler(pickle.Unpickler):
    """Reads a lookup table pickled by the JAX package: its projections
    (``quakemigrate_tpu.coords``) are rebuilt as the port's own
    (``quakemigrate_torch.coords``, which pickles them the same way), so
    the JAX package is never imported. Any other class resolves as
    pickle resolves it: a table whose station data is a DataFrame needs
    pandas installed to be read, as any pickle of one does."""

    def find_class(self, module, name):
        if module.split(".")[0] == "quakemigrate_tpu":
            module = "quakemigrate_torch" + module[len("quakemigrate_tpu"):]
        return super().find_class(module, name)


def update_lut(old_lut_file, save_file):
    """
    Convert an old-format pickled LUT to the current layout and save it
    in the port's format (:meth:`LUT.save`).

    Old-format files carry a ``maps`` dict keyed
    ``station -> {"TIME_P": tt, "TIME_S": tt}`` and ``_cell_size`` /
    ``_cell_count`` grid attributes; these become ``traveltimes``
    (``station -> {"P": tt, "S": tt}``) and ``node_spacing`` /
    ``node_count``. As the JAX package's ``update_lut`` does, the
    converted table takes phases ["P", "S"] and ``fraction_tt`` 0.1.

    Parameters
    ----------
    old_lut_file : str
        Path of the old-format lookup table (a pickled state dict).
    save_file : str
        Where to write the converted lookup table.

    """

    with open(old_lut_file, "rb") as f:
        state = _OldLUTUnpickler(f).load()

    if "maps" in state:
        traveltimes = {
            station: {
                phase_label.split("_")[1]: table
                for phase_label, table in phase_tables.items()
            }
            for station, phase_tables in state["maps"].items()
        }
    else:
        traveltimes = state["traveltimes"]
    grid = ("_cell_size", "_cell_count") if "_cell_size" in state else (
        "_node_spacing", "_node_count")

    lut = lut_from_reference({
        "ll_corner": state["ll_corner"],
        "ur_corner": state["ur_corner"],
        "node_spacing": state[grid[0]],
        "node_count": state[grid[1]],
        "grid_proj": state["grid_proj"].definition(),
        "coord_proj": state["coord_proj"].definition(),
        "stations": state["station_data"],
        "traveltimes": traveltimes,
        "phases": ["P", "S"],
        "fraction_tt": 0.1,
        "velocity_model": state.get("velocity_model", ""),
    })
    lut.save(save_file)
