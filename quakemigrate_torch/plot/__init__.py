# -*- coding: utf-8 -*-
"""
quakemigrate_torch.plot -- summary figures for each pipeline stage, drawn
as the JAX package's ``plot`` draws them, from the port's own tables.

matplotlib is optional. No module of the port imports it at import time:
each figure function asks :func:`pyplot` for it when it draws. A stage
probes :func:`available` once at its start; where a figure option is on
and matplotlib cannot be imported, it logs one warning and runs without
drawing.

"""

import functools
import importlib.util
import logging
import os


@functools.cache
def available():
    """Whether matplotlib can be imported (probed once a process)."""

    try:
        return importlib.util.find_spec("matplotlib") is not None
    except (ImportError, ValueError):
        return False


def pyplot():
    """``matplotlib.pyplot``, on the Agg backend where no display is set
    (as the JAX package selects it)."""

    import matplotlib

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def missing_warning(stage, options):
    """The one warning a stage logs when figure ``options`` are on and
    matplotlib cannot be imported."""

    logging.warning(
        f"\t{stage}: matplotlib cannot be imported; the figures of "
        f"{', '.join(options)} will not be drawn.")


from .event import event_summary  # noqa: E402,F401
from .trigger import trigger_summary  # noqa: E402,F401
from .phase_picks import pick_summary  # noqa: E402,F401
from .amplitudes import amplitudes_summary  # noqa: E402,F401
