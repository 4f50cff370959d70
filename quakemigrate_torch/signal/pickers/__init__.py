# -*- coding: utf-8 -*-
"""
quakemigrate_torch.signal.pickers -- phase-picking classes.

"""

from .base import PhasePicker  # noqa: F401
from .gaussian import GaussianPicker  # noqa: F401
