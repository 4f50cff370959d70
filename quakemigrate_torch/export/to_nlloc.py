# -*- coding: utf-8 -*-
"""
NonLinLoc phase (OBS) file export: one GAU-weighted observation line per
usable pick (the JAX package's ``export/to_nlloc.py``).

"""

import warnings

from quakemigrate_torch.seis import UTCDateTime


def _observation_line(pick, autopick):
    """One NLLoc OBS line for a pick, or None for failed (-1) picks."""

    stamp = pick["PickTime"] if autopick else pick["ModelledTime"]
    if str(stamp) == "-1":
        return None
    when = UTCDateTime(str(stamp))

    station = (str(pick["Station"]) or "?").ljust(6)
    phase = (str(pick["Phase"]) or "?").ljust(6)

    if autopick:
        try:
            uncertainty = float(pick["PickError"])
        except (KeyError, ValueError):
            uncertainty = -1
    else:
        uncertainty = -1

    q = "?"
    seconds = when.second + when.microsecond * 1e-6
    weights = " ".join(f"{w:9.2e}" for w in (uncertainty, -1, -1, -1, 1))
    return (
        f"{station} {q.ljust(4)} {q.ljust(4)} {q} {phase} {q} "
        f"{when.strftime('%Y%m%d')} {when.strftime('%H%M')} "
        f"{seconds:7.4f} GAU {weights}"
    )


def nlloc_obs(event, filename, autopick=True):
    """
    Write the NonLinLoc Phase file for one
    :class:`~quakemigrate_torch.export.catalog.EventRecord`.

    Parameters
    ----------
    event : EventRecord
        Event with a picks table.
    filename : str
        Output phase file path.
    autopick : bool, optional
        Use the autopicked times (True) or the modelled arrival times.

    """

    lines = []
    if event.picks is not None:
        lines = [
            line
            for pick in event.picks.rows()
            if (line := _observation_line(pick, autopick)) is not None
        ]

    if not lines:
        warnings.warn("No pick information, writing empty NLLOC OBS file.")
        body = ""
    else:
        body = "\n".join(sorted(lines) + [""])

    with open(filename, "w") as fh:
        fh.write(body)
