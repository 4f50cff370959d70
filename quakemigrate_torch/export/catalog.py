# -*- coding: utf-8 -*-
"""
Catalog model: a completed run's locate outputs (.event, .picks and
.amps files) read back into light event records for export. The files
are read as :class:`~quakemigrate_torch.io.table.Table`\\ s typed as
pandas' ``read_csv`` types them, so each value is the one the JAX
package's DataFrames hold.

"""

import pathlib
from dataclasses import dataclass, field

from quakemigrate_torch.io.table import Table, read_table
from quakemigrate_torch.seis import UTCDateTime


@dataclass
class EventRecord:
    """Everything read back from one located event's output files.
    ``picks`` is the .picks file's table; ``amps`` the .amps file's, its
    first column ``id`` the index the file was written with."""

    uid: str
    otime: UTCDateTime
    longitude: float
    latitude: float
    depth_km: float
    gau_longitude: float = None
    gau_latitude: float = None
    gau_depth_km: float = None
    err_x_km: float = None
    err_y_km: float = None
    err_z_km: float = None
    cov_err_xyz_km: float = None
    coa: float = None
    coa_norm: float = None
    trig_coa: float = None
    dec_coa: float = None
    ml: float = None
    ml_err: float = None
    ml_r2: float = None
    picks: Table = None
    amps: Table = None
    extra: dict = field(default_factory=dict)


def read_run(run_dir, units, run_subname="", local_mag_ph="S"):
    """
    Read all located events from a run directory into EventRecords.

    Parameters
    ----------
    run_dir : str
        Path to the run directory.
    units : {"km", "m"}
        Units of the LUT grid projection (depth/uncertainty scaling in the
        .event files).
    run_subname : str, optional
    local_mag_ph : {"S", "P"}, optional
        Which amplitude measurement feeds the local magnitude.

    """

    locate_dir = pathlib.Path(run_dir) / "locate" / run_subname
    events_dir = locate_dir / "events"

    if units not in ("km", "m"):
        raise AttributeError(f"units must be 'km' or 'm'; not {units}")

    records = []
    if not events_dir.is_dir():
        return records

    unit_factor = 1.0 if units == "km" else 1e-3

    for event_file in sorted(events_dir.glob("*.event")):
        table = read_table(event_file)
        if not len(table):
            continue
        row = table.row(0)
        uid = str(row["EventID"])

        record = EventRecord(
            uid=uid,
            otime=UTCDateTime(str(row["DT"])),
            longitude=float(row["X"]),
            latitude=float(row["Y"]),
            depth_km=float(row["Z"]) * unit_factor,
            gau_longitude=float(row["GAU_X"]),
            gau_latitude=float(row["GAU_Y"]),
            gau_depth_km=float(row["GAU_Z"]) * unit_factor,
            err_x_km=float(row["GAU_ErrX"]) * unit_factor,
            err_y_km=float(row["GAU_ErrY"]) * unit_factor,
            err_z_km=float(row["GAU_ErrZ"]) * unit_factor,
            cov_err_xyz_km=float(row["COV_Err_XYZ"]) * unit_factor,
            coa=float(row["COA"]),
            coa_norm=float(row["COA_NORM"]),
            trig_coa=float(row["TRIG_COA"]),
            dec_coa=float(row["DEC_COA"]),
        )
        if "ML" in row:
            record.ml = float(row["ML"])
            record.ml_err = float(row["ML_Err"])
            record.ml_r2 = float(row["ML_r2"])

        pick_file = locate_dir / "picks" / f"{uid}.picks"
        if pick_file.is_file():
            record.picks = read_table(pick_file)

        amps_file = locate_dir / "amplitudes" / f"{uid}.amps"
        if amps_file.is_file():
            record.amps = read_table(amps_file)

        record.extra["local_mag_ph"] = local_mag_ph
        records.append(record)

    return records
