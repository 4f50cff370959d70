# -*- coding: utf-8 -*-
"""
SEED RESP response file reader, the port's copy of the JAX package's
``seis/resp.py``.

The reference reads "a concatenated series of RESP files" through ObsPy
(reference: io/core.py:110-114); this is a native parser for the same
evalresp text format (dataless-SEED blockette dumps): B050/B052 station
and channel epochs, B053 poles-zeros stages, B054 coefficient stages,
B057 decimation, B058 stage gains (stage 0 = overall sensitivity), and
B061 FIR stages with symmetry codes. Produces the same
:class:`~quakemigrate_torch.seis.response.Inventory` as the StationXML and
SAC_PZ readers.

"""

import re
from pathlib import Path

import numpy as np

from quakemigrate_torch.util import ResponseNotFoundError

_FIELD = re.compile(r"^(B0\d\d)F(\d\d(?:-\d\d)?)\s+(?:.*?:)?\s*(.*?)\s*$")


def _parse_epochs(text):
    """Split RESP text into channel epochs, each a list of (code, value)."""

    epochs = []
    current = []
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _FIELD.match(line)
        if not m:
            continue
        code = f"{m.group(1)}F{m.group(2)}"
        value = m.group(3)
        # A new B050F03 (station) or B052F03 (location) header after we've
        # already collected response fields starts a new epoch
        if code in ("B050F03", "B052F03") and any(
            c.startswith(("B053", "B054", "B058", "B061")) for c, _ in current
        ):
            epochs.append(current)
            current = []
        current.append((code, value))
    if current:
        epochs.append(current)
    return epochs


def _first_number(value):
    return float(value.split()[0])


def _parse_resp_date(value):
    """
    SEED epoch dates come as "YYYY,DDD,HH:MM:SS[.FFFF]" but the
    time-of-day (and even the day) fields are optional ("2006,169" is
    valid and emitted by several tools); a missing field must not
    silently turn into an any-time-matching None.

    """

    from .utcdatetime import UTCDateTime

    parts = [p for p in str(value).split(",") if p.strip()]
    if not parts or not parts[0].strip().isdigit():
        return None  # e.g. "No Ending Time"
    try:
        year = int(parts[0])
        julday = int(parts[1]) if len(parts) > 1 and parts[1].strip() else 1
        seconds = 0.0
        if len(parts) > 2 and parts[2].strip():
            hms = parts[2].split(":")
            seconds = int(hms[0]) * 3600
            if len(hms) > 1:
                seconds += int(hms[1]) * 60
            if len(hms) > 2:
                seconds += float(hms[2])
        return UTCDateTime(year=year, julday=julday) + seconds
    except (ValueError, IndexError):
        return None


def _parse_epoch(fields):
    """Build (seed_id, ChannelResponse) from one epoch's fields."""

    from .response import ChannelResponse, DigitalStage
    from .utcdatetime import UTCDateTime

    net = sta = cha = ""
    loc = ""
    start = end = None
    poles, zeros, a0 = [], [], 1.0
    pz_type = "A"
    input_units = "M/S"
    found_pz = False
    sensitivity = None
    stage_gains = {}

    # Per-stage digital data keyed by stage number
    stage_coeffs = {}
    stage_symmetry = {}
    stage_fs = {}
    stage_corr = {}

    stage = None

    for code, value in fields:
        if code == "B050F03":
            sta = value.split()[0] if value else ""
        elif code == "B050F16":
            net = value.split()[0] if value else ""
        elif code == "B052F03":
            loc = "" if value in ("??", "  ", "") else value.split()[0]
        elif code == "B052F04":
            cha = value.split()[0] if value else ""
        elif code == "B052F22":
            start = _parse_resp_date(value)
        elif code == "B052F23":
            end = _parse_resp_date(value)  # None for "No Ending Time"

        # --- B053: poles and zeros (first PZ stage only) ---
        elif code == "B053F03":
            if poles or zeros:
                found_pz = True  # a second PZ stage starts: ignore it
            else:
                pz_type = value.split()[0] if value else "A"
        elif code == "B053F04":
            stage = int(_first_number(value))
        elif code == "B053F05" and not found_pz and value:
            input_units = value.split()[0].upper().rstrip(",")
        elif code == "B053F07" and not found_pz:
            a0 = _first_number(value)
        elif code == "B053F10-13" and not found_pz:
            parts = value.split()
            zeros.append(complex(float(parts[1]), float(parts[2])))
        elif code == "B053F15-18" and not found_pz:
            parts = value.split()
            poles.append(complex(float(parts[1]), float(parts[2])))

        # --- B054: coefficients ---
        elif code == "B054F04":
            stage = int(_first_number(value))
            stage_coeffs.setdefault(stage, [])
        elif code == "B054F08-09":
            parts = value.split()
            stage_coeffs[stage].append(float(parts[1]))

        # --- B061: FIR ---
        elif code == "B061F04":
            stage = int(_first_number(value))
            stage_coeffs.setdefault(stage, [])
        elif code == "B061F05":
            stage_symmetry[stage] = value.split()[0].upper() if value else "A"
        elif code == "B061F08-09" or code == "B061F09":
            parts = value.split()
            stage_coeffs[stage].append(float(parts[-1]))

        # --- B057: decimation ---
        elif code == "B057F03":
            stage = int(_first_number(value))
        elif code == "B057F04":
            stage_fs[stage] = _first_number(value)
        elif code == "B057F08":
            try:
                stage_corr[stage] = _first_number(value)
            except (ValueError, IndexError):
                pass

        # --- B058: gains ---
        elif code == "B058F03":
            stage = int(_first_number(value))
        elif code == "B058F04":
            stage_gains[stage] = _first_number(value)

    if pz_type.upper().startswith("B"):
        # Analog response in Hz: convert to rad/s
        scale = 2 * np.pi
        zeros = [z * scale for z in zeros]
        poles = [p * scale for p in poles]
        a0 *= scale ** (len(poles) - len(zeros))

    # Overall sensitivity: the stage-0 gain if present, else the product
    # of the per-stage gains
    if 0 in stage_gains:
        sensitivity = stage_gains[0]
    else:
        sensitivity = float(np.prod([g for s, g in stage_gains.items() if s]))

    digital = []
    for s in sorted(stage_coeffs):
        coeffs = stage_coeffs[s]
        if not coeffs or s not in stage_fs:
            continue
        sym = stage_symmetry.get(s, "A")
        if sym == "B":  # odd: center listed last
            coeffs = coeffs + coeffs[-2::-1]
        elif sym == "C":  # even
            coeffs = coeffs + coeffs[::-1]
        digital.append(
            DigitalStage(
                coefficients=np.asarray(coeffs, dtype=np.float64),
                input_sample_rate=stage_fs[s],
                correction=stage_corr.get(s),
            )
        )

    seed_id = f"{net}.{sta}.{loc}.{cha}"
    return seed_id, ChannelResponse(
        poles=poles,
        zeros=zeros,
        normalization_factor=a0,
        sensitivity=sensitivity,
        input_units=input_units,
        start=start,
        end=end,
        digital_stages=digital,
    )


def read_resp(path):
    """
    Read RESP file(s) into an
    :class:`~quakemigrate_torch.seis.response.Inventory`. ``path`` may be a
    single (possibly concatenated) RESP file or a directory of
    ``RESP.NET.STA.LOC.CHA`` files.

    """

    from .response import Inventory

    path = Path(path)
    if path.is_dir():
        files = sorted(
            p for p in path.iterdir()
            if p.is_file() and p.name.upper().startswith("RESP")
        )
        if not files:
            raise ResponseNotFoundError(
                f"No RESP files found in directory {path}", str(path)
            )
    else:
        files = [path]

    inv = Inventory()
    for f in files:
        for fields in _parse_epochs(f.read_text()):
            seed_id, resp = _parse_epoch(fields)
            if seed_id.strip(".") == "":
                continue
            inv.responses.setdefault(seed_id, []).append(resp)

    if not inv.responses:
        raise ResponseNotFoundError(
            f"No response epochs found in {path}", str(path)
        )
    return inv
