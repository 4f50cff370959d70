# -*- coding: utf-8 -*-
"""Continuous-scan entry points of the port."""

from .scan import DetectScan, QuakeScan  # noqa: F401
