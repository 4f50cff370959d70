# -*- coding: utf-8 -*-
"""Tensor programs of the detect path: onset front end, migration, the
kernels' wrappers and plain versions, and the kernel breakdown; and the
three STA/LTA onset functions."""

from .stalta import (  # noqa: F401
    centred_sta_lta,
    overlapping_sta_lta,
    recursive_sta_lta,
)
