# -*- coding: utf-8 -*-
"""
SAC pole-zero (SAC_PZ) response file reader, the port's copy of the JAX
package's ``seis/sacpz.py``.

The reference declines these files ("SAC_PZ is not yet supported",
reference: io/core.py:132-135); here they are parsed natively into the
same :class:`~quakemigrate_torch.seis.response.Inventory` the StationXML
reader produces, so `Archive(response_inv=...)` works with either source.

A SAC_PZ block is the rdseed/IRIS convention: `*`-prefixed comment
headers (NETWORK/STATION/CHANNEL/LOCATION/START/END/INPUT UNIT), then
ZEROS/POLES counts with complex values (rad/s), and CONSTANT = A0
normalisation x overall sensitivity. Unlisted zeros/poles are at the
origin. The transfer function is conventionally w.r.t. displacement
(input unit M) -- the extra zero relative to a velocity response is
expected in the file.

"""

import re
from pathlib import Path

from quakemigrate_torch.util import ResponseNotFoundError


def _parse_blocks(text):
    """Split a SAC_PZ file into blocks, one per ZEROS/POLES/CONSTANT set."""

    blocks = []
    current = {"comments": {}, "zeros": [], "poles": [], "constant": 1.0}
    mode = None
    remaining = {"zeros": 0, "poles": 0}
    seen_transfer = False

    def fill_origin():
        # SAC convention: declared-but-unlisted zeros/poles are at 0+0j
        for kind in ("zeros", "poles"):
            while remaining[kind] > 0:
                current[kind].append(0j)
                remaining[kind] -= 1

    def flush():
        nonlocal current, mode, seen_transfer
        fill_origin()
        if seen_transfer:
            blocks.append(current)
        current = {"comments": {}, "zeros": [], "poles": [], "constant": 1.0}
        mode = None
        seen_transfer = False

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("*"):
            m = re.match(
                r"\*\s*([A-Z][A-Z ]*?)(?:\s*\((\w+)\))?\s*:\s*(.*)", line
            )
            if m:
                key = m.group(1).strip().upper()
                if key in current["comments"] and seen_transfer:
                    flush()  # a new block's headers are starting
                current["comments"][key] = m.group(3).strip()
            continue
        upper = line.upper()
        if upper.startswith("ZEROS"):
            if seen_transfer and current["zeros"]:
                flush()  # a bare new ZEROS line starts a new block
            fill_origin()
            remaining["zeros"] = int(line.split()[1])
            mode = "zeros"
            seen_transfer = True
        elif upper.startswith("POLES"):
            fill_origin()
            remaining["poles"] = int(line.split()[1])
            mode = "poles"
            seen_transfer = True
        elif upper.startswith("CONSTANT"):
            current["constant"] = float(line.split()[1])
            mode = None
            flush()
        elif mode in ("zeros", "poles"):
            parts = line.split()
            current[mode].append(complex(float(parts[0]), float(parts[1])))
            remaining[mode] -= 1
            if remaining[mode] <= 0:
                mode = None
    if seen_transfer:
        flush()
    return blocks


_FNAME_RE = re.compile(
    r"SAC_PZs?_(?P<net>[^_]*)_(?P<sta>[^_]+)_(?P<cha>[^_]+)(_(?P<loc>[^_]*))?"
)


def _block_to_response(block, path):
    from .response import ChannelResponse
    from .utcdatetime import UTCDateTime

    comments = block["comments"]
    net = comments.get("NETWORK", "")
    sta = comments.get("STATION", "")
    cha = comments.get("CHANNEL", "")
    loc = comments.get("LOCATION", "")
    if not sta and path is not None:
        m = _FNAME_RE.search(Path(path).name)
        if m:
            net = m.group("net") or net
            sta = m.group("sta") or sta
            cha = m.group("cha") or cha
            loc = m.group("loc") or loc
    if not sta:
        raise ValueError(
            f"SAC_PZ block in {path} has no STATION header and the filename "
            "does not follow the SAC_PZs_NET_STA_CHA convention."
        )
    if loc.upper() in ("--", "  "):
        loc = ""

    def _time(key):
        value = comments.get(key)
        if not value:
            return None
        try:
            return UTCDateTime(value)
        except (ValueError, TypeError):
            return None

    input_units = comments.get("INPUT UNIT", "M").upper() or "M"

    seed_id = f"{net}.{sta}.{loc}.{cha}"
    resp = ChannelResponse(
        poles=list(block["poles"]),
        zeros=list(block["zeros"]),
        normalization_factor=block["constant"],
        sensitivity=1.0,
        input_units=input_units,
        start=_time("START"),
        end=_time("END"),
    )
    return seed_id, resp, comments


def read_sac_pz(path):
    """
    Read SAC pole-zero response file(s) into an
    :class:`~quakemigrate_torch.seis.response.Inventory`. ``path`` may be a
    single file (one or more concatenated PZ blocks) or a directory of
    SAC_PZ files.

    """

    from .response import Inventory

    path = Path(path)
    if path.is_dir():
        files = sorted(
            p for p in path.iterdir()
            if p.is_file() and ("PZ" in p.name.upper() or
                                p.suffix.lower() == ".pz")
        )
        if not files:
            raise ResponseNotFoundError(
                f"No SAC_PZ files found in directory {path}", str(path)
            )
    else:
        files = [path]

    inv = Inventory()
    for f in files:
        for block in _parse_blocks(f.read_text()):
            seed_id, resp, comments = _block_to_response(block, f)
            inv.responses.setdefault(seed_id, []).append(resp)
            lat = comments.get("LATITUDE")
            lon = comments.get("LONGITUDE")
            if lat and lon:
                net_sta = ".".join(seed_id.split(".")[:2])
                elev = comments.get("ELEVATION", "0") or "0"
                try:
                    inv.stations.setdefault(net_sta, {
                        "latitude": float(lat),
                        "longitude": float(lon),
                        "elevation": float(elev.split()[0]),
                    })
                except ValueError:
                    pass

    if not inv.responses:
        raise ResponseNotFoundError(
            f"No pole-zero blocks found in {path}", str(path)
        )
    return inv
