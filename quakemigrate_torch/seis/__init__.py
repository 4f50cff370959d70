# -*- coding: utf-8 -*-
"""
quakemigrate_torch.seis -- the seismic waveform data layer of the port:
the Stream/Trace/UTCDateTime data model and miniSEED I/O (with the port's
own C STEIM1/2 codec), copied from the JAX package's ``seis`` for the
formats and methods the detect and locate paths use, and the instrument
response layer (PAZ removal and simulation, the StationXML reader).

"""

from .utcdatetime import UTCDateTime  # noqa: F401
from .trace import Stats, Stream, Trace  # noqa: F401
from .response import Inventory, read_inventory, simulate_seismometer  # noqa: F401


def read(path, starttime=None, endtime=None, nearest_sample=True, format=None):
    """
    Read a miniSEED file into a Stream (the one waveform format of the
    port). A file that is not miniSEED raises TypeError.

    """

    path = str(path)
    if format is None:
        with open(path, "rb") as f:
            head = f.read(16)
        if len(head) >= 8 and head[6:7] in b"DRQM" and head[:6].isdigit():
            format = "MSEED"
    if format is None or format.upper() != "MSEED":
        raise TypeError(f"Unknown or unsupported waveform format: {path}")

    from .mseed import read_mseed

    return read_mseed(
        path, starttime=starttime, endtime=endtime,
        nearest_sample=nearest_sample,
    )
