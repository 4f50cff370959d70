# -*- coding: utf-8 -*-
"""
Abstract base class for phase pickers, plus the .picks file writer
(schema: Station, Phase, ModelledTime, PickTime, PickError, SNR, Residual;
-1 sentinels for failed picks), the port of the JAX package's
``signal/pickers/base.py``. The picks are a
:class:`~quakemigrate_torch.io.table.Table`, written as the text pandas'
``to_csv`` writes for the same frame.

"""

from abc import ABC, abstractmethod

import quakemigrate_torch.util as util


class PhasePicker(ABC):
    """Abstract base for phase-picking implementations."""

    def __init__(self, **kwargs):
        self.plot_picks = kwargs.get("plot_picks", True)

    def __str__(self):
        return (
            "Base PhasePicker object - add a __str__ method to your "
            "PhasePicker class"
        )

    @abstractmethod
    def pick_phases(self, event, lut, run):
        """Pick phase arrival times. Returns (event, picks Table)."""

    @util.timeit()
    def write(self, run, event_uid, phase_picks):
        """Write the picks table to a .picks CSV."""

        fpath = run.path / "locate" / run.subname / "picks"
        fpath.mkdir(exist_ok=True, parents=True)

        phase_picks.to_csv((fpath / f"{event_uid}").with_suffix(".picks"))

    def plot(self, *args, **kwargs):
        """Optional plot hook; implemented by subclasses."""
