# -*- coding: utf-8 -*-
"""
Support for user-supplied coordinate overlay files ("XY files"): a CSV
listing [File, Color, Linewidth, Linestyle] rows, where each File contains
Longitude,Latitude pairs (no headers; '#' comments allowed) -- e.g. coast
lines, volcano outlines, mapped faults (reference usage:
quakemigrate/signal/scan.py xy_files parameter).

File entries resolve as given (absolute or relative to the working
directory, matching the reference convention), with a fallback to the
spec file's own directory.

"""

import logging
import pathlib

import numpy as np


def plot_xy_files(xy_files, ax):
    """Overlay each coordinate file on a lon/lat axis."""

    if xy_files is None:
        return

    xy_files = pathlib.Path(xy_files)
    try:
        lines = xy_files.read_text().splitlines()
    except OSError as e:
        logging.warning(f"Could not read xy_files spec {xy_files}: {e}")
        return

    # Parse line-by-line: the spec is user-edited, one bad row must not
    # take down the rest of the overlay (and genfromtxt rejects ragged
    # rows outright).
    spec = [
        [field.strip() for field in line.split(",")]
        for line in lines
        if line.strip() and not line.lstrip().startswith("#")
    ]

    for row in spec:
        if len(row) < 4:
            logging.warning(
                f"Skipping malformed xy_files row (need File,Color,"
                f"Linewidth,Linestyle): {list(row)}"
            )
            continue
        fname, color, linewidth, linestyle = [str(v).strip() for v in row[:4]]
        path = pathlib.Path(fname)
        if not path.exists():
            fallback = xy_files.parent / path.name
            if fallback.exists():
                path = fallback
        try:
            coords = np.genfromtxt(path, delimiter=",", comments="#",
                                   ndmin=2)
            ax.plot(
                coords[:, 0], coords[:, 1], c=color,
                lw=float(linewidth), ls=linestyle, zorder=5,
            )
        except (OSError, ValueError, IndexError) as e:
            logging.warning(f"Could not plot xy file {path}: {e}")
            continue
