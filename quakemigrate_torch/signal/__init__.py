# -*- coding: utf-8 -*-
"""The scan entry points of the port: detect and locate (QuakeScan) and
triggering (Trigger)."""

from .scan import DetectScan, QuakeScan  # noqa: F401
from .trigger import Trigger  # noqa: F401
