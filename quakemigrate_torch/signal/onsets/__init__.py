# -*- coding: utf-8 -*-
"""Onset functions of the port: the STA/LTA and kurtosis onsets' host
side."""

from .base import Onset, OnsetData  # noqa: F401
from .stalta import (  # noqa: F401
    CentredSTALTAOnset,
    ClassicSTALTAOnset,
    STALTAOnset,
    pre_process,
)
from .kurtosis import KurtosisOnset  # noqa: F401
