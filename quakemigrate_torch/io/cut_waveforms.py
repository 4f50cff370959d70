# -*- coding: utf-8 -*-
"""
Per-event cut-waveform output of locate, the port of the JAX package's
``io/cut_waveforms.py`` for raw waveforms in MSEED, the one waveform
format the port writes (``Stream.write`` raises on another).
Response-removed ("real") and Wood-Anderson waveforms need the
instrument-response layer, which is not ported (ROADMAP.md §1, A8c).

"""

import logging

import quakemigrate_torch.util as util
from quakemigrate_torch.seis import Stream

@util.timeit("info")
def write_cut_waveforms(run, event, file_format, pre_cut=0.0, post_cut=0.0):
    """Cut and write an event's raw waveforms."""

    logging.info("\tSaving raw cut waveforms...")

    outdir = run.path / "locate" / run.subname / "raw_cut_waveforms"
    outdir.mkdir(exist_ok=True, parents=True)

    st = _cut(event.data.raw_waveforms, event.otime, pre_cut, post_cut)
    if not bool(st):
        logging.info(f"\t\tNo raw cut waveform data for event {event.uid}!")
        return
    st.write(str((outdir / f"{event.uid}").with_suffix(".m")),
             format=file_format)


def _cut(st, otime, pre_cut, post_cut):
    """Trim traces to otime - pre_cut .. otime + post_cut, dropping empties."""

    if pre_cut:
        for tr in st.traces:
            tr.trim(starttime=otime - pre_cut)
    if post_cut:
        for tr in st.traces:
            tr.trim(endtime=otime + post_cut)

    kept = Stream()
    for tr in st:
        if bool(tr):
            kept += tr
    return kept
