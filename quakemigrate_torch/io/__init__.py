# -*- coding: utf-8 -*-
"""
quakemigrate_torch.io -- the input/output of the detect stage: the Run
paths, the station and lookup-table readers, the waveform archive, and
the .scanmseed and StationAvailability writers.

"""

from .core import Run, read_lut, read_stations  # noqa: F401
from .data import Archive, WaveformData  # noqa: F401
from .scanmseed import ScanmSEED  # noqa: F401
from .availability import write_availability  # noqa: F401
