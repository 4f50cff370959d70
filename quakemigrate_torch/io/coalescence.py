# -*- coding: utf-8 -*-
"""
Coalescence map output of locate: the marginalised 3-D coalescence map of
an event as a .npy file (the ``write_marginal_coalescence`` option), the
port of the JAX package's ``io/coalescence.py::write_coalescence`` for
that map. The port's locate never builds the 4-D map, so it has no
writer for it.

"""

import numpy as np

import quakemigrate_torch.util as util


@util.timeit("info")
def write_coalescence(run, coalescence_map, event):
    """Write an event's marginalised coalescence map to .npy."""

    outdir = run.path / "locate" / run.subname / "marginalised_coalescence_maps"
    outdir.mkdir(exist_ok=True, parents=True)
    np.save(outdir / f"{event.uid}.npy", np.asarray(coalescence_map))
