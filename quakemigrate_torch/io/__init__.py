# -*- coding: utf-8 -*-
"""
quakemigrate_torch.io -- the input/output of detect, trigger and locate:
the Run paths, the station, velocity model and lookup-table readers,
the waveform archive, the .scanmseed and StationAvailability files, the
TriggeredEvents files, the Event and its .event file, the instrument
response inventory, and the coalescence maps (4-D and marginal), cut
waveforms and .amps files of locate.

"""

from .core import (  # noqa: F401
    Run,
    read_lut,
    read_response_inv,
    read_stations,
    read_vmodel,
    stations,
)
from .data import Archive, WaveformData  # noqa: F401
from .event import Event  # noqa: F401
from .scanmseed import ScanmSEED, read_scanmseed  # noqa: F401
from .triggered_events import (  # noqa: F401
    read_triggered_events,
    write_triggered_events,
)
from .availability import read_availability, write_availability  # noqa: F401
from .coalescence import read_coalescence, write_coalescence  # noqa: F401
from .amplitudes import write_amplitudes  # noqa: F401
from .cut_waveforms import write_cut_waveforms  # noqa: F401
