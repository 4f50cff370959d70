# -*- coding: utf-8 -*-
"""Continuous-scan entry points of the port."""

from .scan import DetectScan  # noqa: F401
