# -*- coding: utf-8 -*-
"""
QuakeML 1.2 export: write a run's located events as a standards-compliant
QuakeML document -- the interchange path to ObsPy/SeisComP/etc. without
requiring ObsPy at export time. ``read_quakemigrate`` returns an ObsPy
Catalog if ObsPy is importable, else the run's EventRecords.

The document is the JAX package's byte for byte, its resource
identifiers included (``smi:local/quakemigrate_tpu``), so a catalogue
exported by either package names the same resources.

"""

import pathlib
from xml.sax.saxutils import escape

from .catalog import read_run

_NS = "http://quakeml.org/xmlns/bed/1.2"
_QNS = "http://quakeml.org/xmlns/quakeml/1.2"
_SMI = "smi:local/quakemigrate_tpu"  # shared with the JAX package


def _pick_xml(uid, i, pick):
    pick_time = pick["PickTime"]
    if str(pick_time) == "-1":
        return ""
    station = pick["Station"]
    phase = pick["Phase"]
    error = float(pick["PickError"])
    out = [
        f'    <pick publicID="{_SMI}/pick/{uid}/{i}">',
        "      <time>",
        f"        <value>{pick_time}</value>",
        f"        <uncertainty>{error}</uncertainty>",
        "      </time>",
        # networkCode is use="required" in QuakeML 1.2's
        # WaveformStreamID; ObsPy emits an empty one for the same reason
        f'      <waveformID networkCode="" '
        f'stationCode="{escape(str(station))}"/>',
        f"      <phaseHint>{escape(str(phase))}</phaseHint>",
        f"      <methodID>{_SMI}/method/gaussian_picker</methodID>",
        "    </pick>",
    ]
    return "\n".join(out) + "\n"


def _finite(value):
    """None for missing/NaN values: 'nan' is not valid xs:double."""

    if value is None:
        return None
    value = float(value)
    return value if value == value else None


def _event_xml(record):
    uid = record.uid
    out = [f'  <event publicID="{_SMI}/event/{uid}">']

    # Origin (spline location is the preferred hypocentre)
    out += [
        f'    <origin publicID="{_SMI}/origin/{uid}">',
        "      <time>",
        f"        <value>{record.otime}</value>",
        "      </time>",
        "      <longitude>",
        f"        <value>{record.longitude}</value>",
        "      </longitude>",
        "      <latitude>",
        f"        <value>{record.latitude}</value>",
        "      </latitude>",
        "      <depth>",
        f"        <value>{record.depth_km * 1000.0}</value>",
    ]
    if _finite(record.err_z_km) is not None:
        out.append(f"        <uncertainty>{record.err_z_km * 1000.0}</uncertainty>")
    out += [
        "      </depth>",
        f"      <methodID>{_SMI}/method/coalescence_migration</methodID>",
    ]
    horiz = (
        None
        if _finite(record.err_x_km) is None or _finite(record.err_y_km) is None
        else max(record.err_x_km, record.err_y_km) * 1000.0
    )
    if _finite(record.cov_err_xyz_km) is not None and horiz is not None:
        out += [
            "      <originUncertainty>",
            # Only horizontalUncertainty is populated, so that (not
            # "uncertainty ellipse", whose min/max/azimuth elements are
            # absent) is the correct preferred description
            "        <preferredDescription>horizontal uncertainty"
            "</preferredDescription>",
            f"        <horizontalUncertainty>{horiz}"
            f"</horizontalUncertainty>",
            "      </originUncertainty>",
        ]
    out.append("    </origin>")

    # Magnitude
    if _finite(record.ml) is not None:
        out += [
            f'    <magnitude publicID="{_SMI}/magnitude/{uid}">',
            "      <mag>",
            f"        <value>{record.ml}</value>",
        ]
        if _finite(record.ml_err) is not None:
            out.append(
                f"        <uncertainty>{record.ml_err}</uncertainty>"
            )
        out += [
            "      </mag>",
            "      <type>ML</type>",
            f"      <originID>{_SMI}/origin/{uid}</originID>",
            "    </magnitude>",
        ]

    # Picks
    if record.picks is not None:
        for i, pick in enumerate(record.picks.rows()):
            out.append(_pick_xml(uid, i, pick))

    out += [
        f"    <preferredOriginID>{_SMI}/origin/{uid}</preferredOriginID>",
    ]
    if record.ml is not None and record.ml == record.ml:
        out.append(
            f"    <preferredMagnitudeID>{_SMI}/magnitude/{uid}"
            f"</preferredMagnitudeID>"
        )
    out.append("  </event>")

    return "\n".join(out) + "\n"


def write_quakeml(run_dir, output_file, units, run_subname="",
                  local_mag_ph="S"):
    """
    Export all located events from a run directory to a QuakeML file.
    Returns the list of exported EventRecords.

    """

    records = read_run(run_dir, units, run_subname, local_mag_ph)

    parts = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        f'<q:quakeml xmlns:q="{_QNS}" xmlns="{_NS}">',
        f'  <eventParameters publicID="{_SMI}/catalog">',
    ]
    parts += [_event_xml(r) for r in records]
    parts += ["  </eventParameters>", "</q:quakeml>", ""]

    output_file = pathlib.Path(output_file)
    output_file.parent.mkdir(parents=True, exist_ok=True)
    output_file.write_text("\n".join(parts))

    return records


def read_quakemigrate(run_dir, units, run_subname="", local_mag_ph="S"):
    """
    Read a run into an ObsPy Catalog if ObsPy is importable; otherwise
    return the native EventRecord list (same information).

    """

    try:
        import obspy  # noqa: F401
    except ImportError:
        return read_run(run_dir, units, run_subname, local_mag_ph)

    import tempfile

    from obspy import read_events

    with tempfile.NamedTemporaryFile(suffix=".xml") as f:
        write_quakeml(run_dir, f.name, units, run_subname, local_mag_ph)
        return read_events(f.name)
