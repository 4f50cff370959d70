# -*- coding: utf-8 -*-
"""
Per-event cut-waveform output in raw / response-removed ("real") /
Wood-Anderson flavours (reference behaviour: io/cut_waveforms.py:44-213),
the port of the JAX package's ``io/cut_waveforms.py``: MSEED, SAC, GSE2
or SEGY files, through ``Stream.write``.

"""

import logging

import quakemigrate_torch.util as util
from quakemigrate_torch.seis import Stream

_SUFFIXES = {"MSEED": ".m", "SAC": ".sac", "GSE2": ".gse2", "SEGY": ".segy"}


@util.timeit("info")
def write_cut_waveforms(
    run,
    event,
    file_format,
    pre_cut=0.0,
    post_cut=0.0,
    waveform_type="raw",
    units="displacement",
):
    """Cut, (optionally) response-correct, and write an event's waveforms."""

    logging.info(f"\tSaving {waveform_type} cut waveforms...")

    outdir = run.path / "locate" / run.subname / f"{waveform_type}_cut_waveforms"
    outdir.mkdir(exist_ok=True, parents=True)

    st = _cut(event.data.raw_waveforms, event.otime, pre_cut, post_cut)

    if waveform_type in ("real", "wa"):
        stash = {
            "real": event.data.real_waveforms,
            "wa": event.data.wa_waveforms,
        }[waveform_type]
        if isinstance(stash, Stream) and not pre_cut and not post_cut:
            # locate already produced these during magnitude calculation.
            st = stash
        else:
            try:
                st = get_waveforms(st, event, waveform_type, units)
            except AttributeError as err:
                raise AttributeError(
                    "To output real or Wood-Anderson cut waveforms you must "
                    "supply an instrument response inventory."
                ) from err

    if not bool(st):
        logging.info(
            f"\t\tNo {waveform_type} cut waveform data for event {event.uid}!"
        )
        return
    write_waveforms(st, outdir, f"{event.uid}", file_format)


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


@util.timeit("debug")
def get_waveforms(st, event, waveform_type, units):
    """Deconvolve each usable trace to real or Wood-Anderson ground motion."""

    corrected = Stream()
    want_velocity = units == "velocity"
    correct = (
        event.data.get_real_waveform
        if waveform_type == "real"
        else event.data.get_wa_waveform
    )

    for tr in st.copy():
        if not bool(tr) or tr.data.max() == tr.data.min():
            continue
        try:
            corrected.append(correct(tr, want_velocity))
        except (util.ResponseNotFoundError, util.ResponseRemovalError) as err:
            logging.warning(str(err))

    return corrected


@util.timeit("debug")
def write_waveforms(st, fpath, fstem, file_format):
    """Write a stream in the requested format, with its usual suffix."""

    suffix = _SUFFIXES.get(file_format, ".waveforms")
    st.write(str((fpath / fstem).with_suffix(suffix)), format=file_format)
