# -*- coding: utf-8 -*-
"""
The .amps file: per-trace P/S amplitude observations plus individual local
magnitude estimates, with the reference's per-column significant-figure
formatting, the port of the JAX package's ``io/amplitudes.py``. The table
is a :class:`~quakemigrate_torch.io.table.Table` whose first column,
``id``, is the JAX frame's index, and the file is the text pandas'
``to_csv(index=True)`` writes for that frame.

"""

import numpy as np

from .table import Table

# Significant figures per column group in the written file.
_COLUMN_FORMATS = {
    ".5g": ("epi_dist", "z_dist", "P_amp", "P_avg_amp", "S_amp", "S_avg_amp",
            "Noise_amp"),
    ".2g": ("P_freq", "S_freq"),
    ".3g": ("P_filter_gain", "S_filter_gain", "ML", "ML_Err"),
}


def _missing(x):
    return x is None or (isinstance(x, (float, np.floating)) and np.isnan(x))


def write_amplitudes(run, amplitudes, event):
    """Format and write one event's amplitude table to ``<uid>.amps``."""

    outdir = run.path / "locate" / run.subname / "amplitudes"
    outdir.mkdir(exist_ok=True, parents=True)

    formatted = Table({name: amplitudes[name] for name in amplitudes.names},
                      amplitudes.names)
    for spec, columns in _COLUMN_FORMATS.items():
        for column in columns:
            if column not in formatted.names:
                continue
            formatted[column] = [x if _missing(x) else format(x, spec)
                                 for x in formatted[column]]

    formatted.to_csv(outdir / f"{event.uid}.amps")
