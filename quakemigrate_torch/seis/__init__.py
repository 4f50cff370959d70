# -*- coding: utf-8 -*-
"""
quakemigrate_torch.seis -- the seismic waveform data layer of the port:
the Stream/Trace/UTCDateTime data model; waveform I/O in miniSEED (with
the port's own C STEIM1/2 codec), SAC, GSE2 (CM6) and SEG-Y, copied from
the JAX package's ``seis``; and the instrument response layer (PAZ
removal and simulation; StationXML, RESP and SAC_PZ readers).

"""

from .utcdatetime import UTCDateTime  # noqa: F401
from .trace import Stats, Stream, Trace  # noqa: F401
from .response import Inventory, read_inventory, simulate_seismometer  # noqa: F401


def read(path, starttime=None, endtime=None, nearest_sample=True, format=None):
    """
    Read a waveform file into a Stream, trimmed to ``starttime`` ..
    ``endtime`` where given. The format (MSEED, SAC, GSE2 or SEGY) is
    sniffed from the file's first bytes unless given: a file that is none
    of the first three is read as SAC, whose reader raises TypeError on a
    file that is not SAC either. Another ``format`` raises TypeError.

    """

    path = str(path)
    if format is None:
        with open(path, "rb") as f:
            head = f.read(16)
        if len(head) >= 8 and head[6:7] in b"DRQM" and head[:6].isdigit():
            format = "MSEED"
        elif head.startswith(b"WID2"):
            format = "GSE2"
        elif head.startswith(b"C 1 SEG Y"):
            format = "SEGY"
        else:
            format = "SAC"

    if format.upper() == "MSEED":
        from .mseed import read_mseed

        return read_mseed(
            path, starttime=starttime, endtime=endtime,
            nearest_sample=nearest_sample,
        )
    if format.upper() == "SAC":
        from .sac import read_sac

        reader = read_sac
    elif format.upper() == "GSE2":
        from .gse2 import read_gse2

        reader = read_gse2
    elif format.upper() == "SEGY":
        from .segy import read_segy

        reader = read_segy
    else:
        raise TypeError(f"Unknown waveform format: {format}")

    st = reader(path)
    if starttime is not None or endtime is not None:
        st.trim(starttime=starttime, endtime=endtime,
                nearest_sample=nearest_sample)
    return st
