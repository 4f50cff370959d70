# -*- coding: utf-8 -*-
"""
MFAST (shear-wave splitting) export: per-station SAC files with event and
station headers and the P and S pick times (the JAX package's
``export/to_mfast.py``).

"""

import pathlib

from quakemigrate_torch.coords import gps2dist_azimuth
from quakemigrate_torch.seis import Stream, UTCDateTime, read
from quakemigrate_torch.seis.sac import write_sac

from .to_snuffler import _station_rows


def sac_mfast(event, stations, output_path, units, cut_waveforms_file,
              filename=None):
    """
    Write per-station, per-component SAC files for MFAST from an event's
    cut waveforms.

    Parameters
    ----------
    event : :class:`~quakemigrate_torch.export.catalog.EventRecord`
    stations : StationTable, Table or DataFrame
        Station information (Name/Latitude/Longitude/Elevation).
    output_path : str
    units : {"km", "m"}
        LUT grid projection units (elevation scaling).
    cut_waveforms_file : str
        Path to the event's cut-waveform file (any supported format).

    """

    stream = read(cut_waveforms_file)

    if units == "km":
        factor = 1
    elif units == "m":
        factor = 1e3
    else:
        raise AttributeError(f"units must be 'km' or 'm'; not {units}")

    evla, evlo = event.latitude, event.longitude
    evdp = event.depth_km

    eventid = event.uid
    if filename is None:
        filename = eventid + ".{}.{}"
    else:
        filename = filename + ".{}.{}"
    output_path = pathlib.Path(output_path) / eventid
    output_path.mkdir(parents=True, exist_ok=True)

    for station in _station_rows(stations):
        name = station["Name"]
        st = stream.select(station=name)
        if not bool(st):
            continue

        dist, az, _ = gps2dist_azimuth(
            evla, evlo, station["Latitude"], station["Longitude"]
        )

        picks = []
        if event.picks is not None:
            picks = event.picks.take(event.picks["Station"] == name).rows()
        if not picks:
            continue

        reference = st[0].stats.starttime
        origin_time = event.otime - reference
        p_pick = s_pick = 0.0
        for pick in picks:
            time_str = str(pick["PickTime"])
            if time_str == "-1":
                continue
            rel = UTCDateTime(time_str) - reference
            if pick["Phase"] == "P":
                p_pick = rel
            elif pick["Phase"] == "S":
                s_pick = rel

        if s_pick == 0.0:
            # No usable S pick: MFAST windows its splitting measurement
            # around t0, so writing t0=0.0 would hand it noise at the
            # trace start
            continue

        headers = {
            "evla": evla,
            "evlo": evlo,
            "evdp": evdp,
            "stla": station["Latitude"],
            "stlo": station["Longitude"],
            "stel": station["Elevation"] / factor,
            "dist": dist / 1000.0,
            "az": az,
            "o": origin_time,
            "t0": s_pick,
            "kt0": "S",
        }
        if p_pick != 0.0:
            headers["a"] = p_pick

        for tr in st:
            comp = tr.stats.channel[-1].lower() if tr.stats.channel else "x"
            fname = output_path / filename.format(name, comp)
            write_sac(Stream([tr]), str(fname), extra_headers=headers)
