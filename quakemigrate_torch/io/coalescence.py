# -*- coding: utf-8 -*-
"""
Coalescence map I/O of locate: the 4-D coalescence map of an event
(``write_coalescence``, [nx, ny, nz, nsamples] over the marginal window)
and its marginalised 3-D map (``write_marginal_coalescence``) as .npy
files, the port of the JAX package's ``io/coalescence.py``.

"""

import numpy as np

import quakemigrate_torch.util as util


def read_coalescence(fname):
    """Read a coalescence map from a .npy file."""

    return np.load(fname)


@util.timeit("info")
def write_coalescence(run, coalescence_map, event, marginalised=False):
    """Write a coalescence map (3-D marginalised or 4-D) to .npy."""

    kind = "marginalised_coalescence_maps" if marginalised else "coalescence_maps"
    outdir = run.path / "locate" / run.subname / kind
    outdir.mkdir(exist_ok=True, parents=True)
    np.save(outdir / f"{event.uid}.npy", np.asarray(coalescence_map))
