# -*- coding: utf-8 -*-
"""Onset functions of the port: the STA/LTA onset's host side."""

from .base import Onset, OnsetData  # noqa: F401
from .stalta import STALTAOnset, pre_process  # noqa: F401
