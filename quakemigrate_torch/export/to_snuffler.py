# -*- coding: utf-8 -*-
"""
Export helpers for Snuffler (Pyrocko's manual picking interface): station
files and marker files (the JAX package's ``export/to_snuffler.py``).

"""

import pathlib

from quakemigrate_torch.seis import UTCDateTime


def _station_rows(stations):
    """One dict a station of a station table: a
    :class:`~quakemigrate_torch.lut.StationTable`, a
    :class:`~quakemigrate_torch.io.table.Table` or a DataFrame."""

    if hasattr(stations, "iterrows"):
        return [dict(row) for _, row in stations.iterrows()]
    return list(stations.rows())


def snuffler_stations(stations, output_path, filename, network_code=None):
    """Write a Snuffler-compatible station file."""

    output = pathlib.Path(output_path) / filename

    line_template = "{nw}.{stat}. {lat} {lon} {elev} {dep}\n"

    with output.open(mode="w") as f:
        for station in _station_rows(stations):
            code = network_code
            if code is None:
                code = station.get("Network", "")

            f.write(
                line_template.format(
                    nw=code,
                    stat=station["Name"],
                    lat=station["Latitude"],
                    lon=station["Longitude"],
                    elev=station["Elevation"],
                    dep="0",
                )
            )


def snuffler_markers(event, output_path, filename=None):
    """
    Write a Snuffler marker file for one
    :class:`~quakemigrate_torch.export.catalog.EventRecord`.

    """

    if filename is None:
        filename = f"{event.uid}.markers"

    output_path = pathlib.Path(output_path) / str(event.uid)
    output_path.mkdir(parents=True, exist_ok=True)
    output = output_path / filename

    def _stamp(t):
        return (
            f"{t.year}-{t.month:02d}-{t.day:02d} "
            # Zero-padded: an unpadded microsecond field would render
            # e.g. 1234 us as 0.1234 s in Snuffler
            f"{t.hour:02d}:{t.minute:02d}:{t.second:02d}.{t.microsecond:06d}"
        )

    with output.open("w") as f:
        f.write("# Snuffler Markers File Version 0.2\n")
        f.write(
            f"event: {_stamp(event.otime)} 0 {event.uid} 0.0 0.0 None None "
            "None Event None\n"
        )

        if event.picks is None:
            return

        for pick in event.picks.rows():
            time_str = str(pick["PickTime"])
            if time_str == "-1":
                continue
            t = UTCDateTime(time_str)
            comp = "BHZ" if pick["Phase"] == "P" else "BHN"
            f.write(
                f"phase: {_stamp(t)} 5 .{pick['Station']}..{comp} None None "
                f"None {pick['Phase']} None False\n"
            )
