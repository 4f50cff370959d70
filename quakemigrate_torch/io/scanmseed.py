# -*- coding: utf-8 -*-
"""
The .scanmseed continuous coalescence stream (detect-stage output), the
port of the JAX package's ``io/scanmseed.py``: its writer, and its reader
(``read_scanmseed``), which returns the unscaled channels as numpy
columns of a :class:`~quakemigrate_torch.io.table.Table` instead of a
DataFrame.

Precision contract (identical to the reference,
quakemigrate/io/scanmseed.py:79-130): channels COA/COA_N/X/Y/Z are scaled by
1e5 / 1e5 / 1e6 / 1e6 / 1e3·ucf respectively, rounded to int32, and written
as day-split STEIM2 miniSEED (the codec falls back to STEIM1 on 30-bit
difference overflow).

"""

import logging

import numpy as np

import quakemigrate_torch.util as util
from quakemigrate_torch.seis import Stream, Trace, UTCDateTime, read
from .table import Table

_DAY = 86400

# Channel name -> int32 scale factor. Z's factor is multiplied by the grid's
# unit conversion factor (so depths are stored in millimetres).
SCALES = {"COA": 1e5, "COA_N": 1e5, "X": 1e6, "Y": 1e6, "Z": 1e3}

# COA values are clipped here to keep 1e5-scaled data inside int32.
COA_CEILING = 21474.0


class ScanmSEED:
    """Accumulates detect output and writes day-split .scanmseed files."""

    def __init__(self, run, continuous_write, sampling_rate):
        self.run, self.sampling_rate = run, sampling_rate
        self.continuous_write = continuous_write
        self.written, self.stream = False, Stream()

    def append(self, starttime, max_coa, max_coa_n, coord, ucf):
        """Add one timestep of coalescence output to the stream."""

        coord = np.asarray(coord, dtype=np.float64)
        channels = {
            "COA": np.minimum(np.asarray(max_coa, np.float64), COA_CEILING),
            "COA_N": np.minimum(np.asarray(max_coa_n, np.float64),
                                COA_CEILING),
            "X": coord[:, 0],
            "Y": coord[:, 1],
            "Z": coord[:, 2],
        }

        shared_header = dict(
            network="NW", sampling_rate=self.sampling_rate, starttime=starttime
        )
        for name, values in channels.items():
            scale = SCALES[name] * (ucf if name == "Z" else 1.0)
            self.stream += Trace(
                data=np.round(values * scale).astype(np.int32),
                header={**shared_header, "station": name},
            )
        self.written = False

        self._flush_on_day_boundary()
        if self.continuous_write and not self.written:
            self.write()

    def _flush_on_day_boundary(self):
        """
        Write out (and drop) any complete day the stream now contains.

        The stream stays unmerged between appends (merging after every
        timestep re-copies the whole accumulated day, O(day^2) in total).
        Appends are chronological, so the first trace's start and the last
        trace's end bound the coverage; :meth:`write` does the one real
        merge, which still enforces the conflicting-overlap contract.

        """

        start = self.stream[0].stats.starttime
        last = self.stream[-1].stats
        day_end = UTCDateTime(start.date) + _DAY - last.delta
        if last.endtime == day_end:
            # The stream ends exactly at a day boundary: flush it whole.
            self.write()
            self.stream = Stream()
        elif start.julday != last.endtime.julday:
            logging.debug("Timestep doesn't fall at midnight!")
            split = UTCDateTime(last.endtime.date) - last.delta
            self.write(start, split)
            self.stream.trim(starttime=split + last.delta)
            self.written = False

    def empty(self, starttime, timestep, i, msg, ucf):
        """Record a zero-filled timestep (no data, or failed QC)."""

        logging.info(msg)
        n = util.time2sample(timestep, self.sampling_rate)
        zeros = np.zeros(n)
        self.append(
            starttime + timestep * i, zeros, zeros, np.zeros((n, 3)), ucf
        )

    def write(self, write_start=None, write_end=None):
        """Write the stream (optionally a time slice of it) to disk."""

        outdir = self.run.path / "detect" / "scanmseed"
        outdir.mkdir(exist_ok=True, parents=True)

        # The single merge point (appends accumulate unmerged segments).
        self.stream.merge(method=-1)
        st = self.stream
        if write_start is not None and write_end is not None:
            st = st.slice(starttime=write_start, endtime=write_end)

        day = st[0].stats.starttime
        target = outdir / f"{day.year}_{day.julday:03d}.scanmseed"
        st.write(str(target), format="MSEED", encoding="STEIM2")
        self.written = True


@util.timeit()
def read_scanmseed(run, starttime, endtime, pad, ucf):
    """
    Load and unscale .scanmseed data covering [starttime - pad,
    endtime + pad]; returns (Table [DT, COA, COA_N, X, Y, Z], the COA
    trace's stats). DT is datetime64[ns]; the other columns float64.

    """

    indir = run.path / "detect" / "scanmseed"
    readstart, readend = starttime - pad, endtime + pad

    gathered = Stream()
    day = UTCDateTime(readstart.date)
    cursor = readstart
    while day <= readend:
        name = f"{cursor.year}_{cursor.julday:03d}"
        try:
            gathered += read(
                str(indir / f"{name}.scanmseed"),
                starttime=readstart, endtime=readend, format="MSEED",
            )
        except FileNotFoundError:
            logging.info(f"\n\t    No .scanmseed file found for day {name}!")
        day, cursor = day + _DAY, cursor + _DAY

    if not bool(gathered):
        raise util.NoScanMseedDataException
    try:
        gathered.merge(method=-1)
    except util.MergeError as err:
        # Conflicting overlaps between day files: proceed with the
        # unmerged segments, as the JAX reader does; only the first
        # contiguous segment per channel is then analysed, and the
        # coverage report below warns when that truncates the span.
        logging.info(
            f"\t\tWarning: {err} -- using unmerged segments (the span "
            "after the first conflict will not be analysed; see the "
            "coverage warnings below)."
        )

    stats = gathered.select(station="COA")[0].stats
    delta_ns = round(1e9 / stats.sampling_rate)
    dt_ns = (np.int64(stats.starttime.ns)
             + np.arange(stats.npts, dtype=np.int64) * np.int64(delta_ns))
    table = {"DT": dt_ns.view("datetime64[ns]")}
    for name, scale in SCALES.items():
        divisor = scale * (ucf if name == "Z" else 1.0)
        table[name] = gathered.select(station=name)[0].data / divisor

    _report_coverage(stats, starttime, endtime, readstart, readend)
    return Table(table), stats


def _report_coverage(stats, starttime, endtime, readstart, readend):
    """Log any shortfall between requested and available data spans."""

    checks = (
        (
            stats.starttime > starttime,
            "\n\t    Warning! .scanmseed starttime is later than trigger() "
            "starttime!",
            stats.starttime > readstart,
            "\t    Warning! No .scanmseed data found for pre-pad!",
        ),
        (
            stats.endtime < endtime,
            "\n\t    Warning! .scanmseed endtime is before trigger() "
            "endtime!",
            stats.endtime < readend,
            "\t    Warning! No .scanmseed data found for post-pad!",
        ),
    )
    for span_short, span_msg, pad_short, pad_msg in checks:
        if span_short:
            logging.info(span_msg)
        elif pad_short:
            logging.info(pad_msg)
    logging.info(f"\t    ...from {stats.starttime} - {stats.endtime}.")
