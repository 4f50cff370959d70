# -*- coding: utf-8 -*-
"""
Instrument response handling: poles-and-zeros (PAZ) deconvolution/convolution
by spectral division with a water level, and a StationXML inventory reader
that extracts the PAZ transfer function and overall sensitivity per channel.
The port's copy of the JAX package's ``seis/response.py``, numpy only.

This replaces the reference's use of ObsPy's ``Trace.simulate`` /
``Trace.remove_response`` (reference: quakemigrate/io/data.py:648-786) with a
native implementation. The maths is the standard frequency-domain method:

    corrected(f) = data(f) / H_remove(f) * H_simulate(f)

with |H_remove| clipped at ``max|H| * 10**(-water_level/20)`` to stabilise
the division near spectral zeros.

"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from quakemigrate_torch.util import ResponseNotFoundError


def paz_to_freq_resp(freqs, poles, zeros, gain):
    """Evaluate a Laplace-domain PAZ transfer function at frequencies (Hz)."""

    s = 2j * np.pi * np.asarray(freqs)
    num = np.ones_like(s, dtype=complex)
    for zero in zeros:
        num *= s - zero
    den = np.ones_like(s, dtype=complex)
    for pole in poles:
        den *= s - pole
    with np.errstate(divide="ignore", invalid="ignore"):
        resp = gain * num / den
    resp[~np.isfinite(resp)] = 0.0
    return resp


@dataclass
class DigitalStage:
    """
    One digital (FIR / Coefficients) response stage: numerator
    coefficients at the stage's input sampling rate, plus the logger's
    applied delay correction (seconds), if recorded.

    """

    coefficients: np.ndarray
    input_sample_rate: float
    correction: float | None = None

    def freq_resp(self, freqs):
        """
        Normalised frequency response of the stage.

        H(f) = sum_k c_k exp(-2*pi*i*f*k/fs), advanced by the delay the
        data logger already corrected for (Decimation/Correction when
        recorded, else the (N-1)/2-sample group delay of a symmetric
        filter), and normalised to unit gain at DC so that the stage
        contributes shape only -- the overall InstrumentSensitivity
        already carries every stage's gain.

        """

        c = np.asarray(self.coefficients, dtype=np.float64)
        fs = float(self.input_sample_rate)
        f = np.asarray(freqs, dtype=np.float64)
        k = np.arange(c.size)
        h = np.exp(-2j * np.pi * np.outer(f, k) / fs) @ c

        if self.correction is not None:
            delay = float(self.correction)
        elif c.size > 1 and np.allclose(c, c[::-1]):
            delay = (c.size - 1) / (2.0 * fs)
        else:
            delay = 0.0
        if delay:
            h *= np.exp(2j * np.pi * f * delay)

        dc = abs(c.sum())
        if dc > 0:
            h /= dc
        return h


def _cosine_sac_taper(freqs, flimit):
    """SAC-style frequency-domain cosine taper between 4 corner freqs."""

    fl1, fl2, fl3, fl4 = flimit
    taper = np.zeros_like(freqs)

    mid = (freqs >= fl2) & (freqs <= fl3)
    taper[mid] = 1.0

    left = (freqs > fl1) & (freqs < fl2)
    taper[left] = 0.5 * (
        1.0 + np.cos(np.pi * (fl2 - freqs[left]) / (fl2 - fl1))
    )

    right = (freqs > fl3) & (freqs < fl4)
    taper[right] = 0.5 * (
        1.0 + np.cos(np.pi * (freqs[right] - fl3) / (fl4 - fl3))
    )

    return taper


def _apply_water_level(resp, water_level):
    """Clip small |resp| values to a water level relative to max |resp|."""

    absresp = np.abs(resp)
    max_resp = absresp.max()
    if max_resp == 0.0:
        return resp
    floor = max_resp * 10 ** (-water_level / 20.0)
    out = resp.copy()
    small = (absresp > 0) & (absresp < floor)
    out[small] = out[small] * floor / absresp[small]
    zero = absresp == 0
    out[zero] = floor
    return out


def _sim_taper(npts, p):
    """
    ObsPy ``cosine_taper(npts, p, sactaper=True, halfcosine=False)``:
    quarter-cycle cosine ramps over ``p/2`` of each end, with the SAC
    index adjustment (idx2 += 1, idx3 -= 1).

    """

    frac = int(npts * p / 2.0 + 0.5)
    idx1, idx2 = 0, frac - 1 + 1  # sactaper: idx2 += 1
    idx3, idx4 = npts - frac - 1, npts - 1  # sactaper: idx3 -= 1
    win = np.ones(npts)
    if idx2 > idx1:
        i = np.arange(idx1, min(idx2, npts - 1) + 1)
        win[i] = np.cos(np.pi * (idx2 - i) / (2.0 * (idx2 - idx1)))
    if idx4 > idx3 >= 0:
        i = np.arange(max(idx3, 0), idx4 + 1)
        win[i] = np.cos(np.pi * (i - idx3) / (2.0 * (idx4 - idx3)))
    return win


def simulate_seismometer(
    data,
    sampling_rate,
    paz_remove=None,
    paz_simulate=None,
    water_level=60.0,
    pre_filt=None,
    taper=True,
    taper_fraction=0.05,
    stages_remove=None,
    **_ignored,
):
    """
    Deconvolve ``paz_remove`` from (and/or convolve ``paz_simulate`` onto) a
    waveform. PAZ dicts have keys poles, zeros, gain and sensitivity.

    """

    data = np.asarray(data, dtype=np.float64)
    npts = data.size
    if npts == 0:
        return data

    work = data - data.mean()
    if taper:
        # ObsPy's simulate_seismometer applies
        # cosine_taper(npts, taper_fraction, sactaper=True,
        # halfcosine=False): a quarter-cycle (SAC/sine-shaped) ramp over
        # taper_fraction/2 of EACH end -- not the Hann ramp over
        # taper_fraction per end an earlier revision used, which
        # silently changed every deconvolved amplitude.
        work = work * _sim_taper(npts, taper_fraction)

    nfft = 1
    while nfft < 2 * npts:
        nfft *= 2
    spec = np.fft.rfft(work, n=nfft)
    freqs = np.fft.rfftfreq(nfft, d=1.0 / sampling_rate)

    if pre_filt is not None:
        spec *= _cosine_sac_taper(freqs, pre_filt)

    if paz_remove is not None:
        resp = paz_to_freq_resp(
            freqs,
            paz_remove["poles"],
            paz_remove["zeros"],
            paz_remove.get("gain", 1.0),
        )
        resp *= paz_remove.get("sensitivity", 1.0)
        for stage in stages_remove or ():
            resp *= stage.freq_resp(freqs)
        resp = _apply_water_level(resp, water_level)
        spec /= resp
        spec[~np.isfinite(spec)] = 0.0

    if paz_simulate is not None:
        resp = paz_to_freq_resp(
            freqs,
            paz_simulate["poles"],
            paz_simulate["zeros"],
            paz_simulate.get("gain", 1.0),
        )
        resp *= paz_simulate.get("sensitivity", 1.0)
        spec *= resp

    out = np.fft.irfft(spec, n=nfft)[:npts]
    return out


# --- StationXML inventory ---


@dataclass
class ChannelResponse:
    """PAZ + sensitivity for one channel epoch."""

    poles: list
    zeros: list
    normalization_factor: float
    sensitivity: float
    input_units: str = "M/S"
    start: object = None
    end: object = None
    digital_stages: list = field(default_factory=list)

    def get_paz(self):
        return self

    @property
    def instrument_sensitivity(self):
        return _Sensitivity(self.sensitivity)


@dataclass
class _Sensitivity:
    value: float


@dataclass
class Inventory:
    """
    Minimal response inventory: maps SEED ids to per-epoch channel responses.
    Built from StationXML via :func:`read_inventory`.

    """

    responses: dict = field(default_factory=dict)
    stations: dict = field(default_factory=dict)

    def get_response(self, seed_id, datetime=None):
        epochs = self.responses.get(seed_id)
        if not epochs:
            raise ResponseNotFoundError(
                f"No matching response information found for {seed_id}", seed_id
            )
        if datetime is not None:
            for resp in epochs:
                start_ok = resp.start is None or resp.start <= datetime
                end_ok = resp.end is None or datetime <= resp.end
                if start_ok and end_ok:
                    return resp
            # No epoch covers the requested time: erroring (as ObsPy
            # does) beats silently applying a wrong-era response
            raise ResponseNotFoundError(
                f"No response epoch covers {datetime} for {seed_id}",
                seed_id,
            )
        return epochs[0]

    def get_coordinates(self, seed_id, datetime=None):
        key = ".".join(seed_id.split(".")[:2])
        try:
            return self.stations[key]
        except KeyError:
            raise ResponseNotFoundError(
                f"No matching station found for {seed_id}", seed_id
            )


def _strip_ns(tag):
    return re.sub(r"^\{.*\}", "", tag)


def _find(elem, name):
    for child in elem:
        if _strip_ns(child.tag) == name:
            return child
    return None


def _findall(elem, name):
    return [child for child in elem if _strip_ns(child.tag) == name]


def _text(elem, name, default=None):
    child = _find(elem, name)
    return child.text if child is not None else default


def _parse_digital_stage(stage):
    """
    Parse a Coefficients or FIR element (plus its Decimation block) from a
    StationXML Response Stage into a :class:`DigitalStage`, expanding
    symmetric FIR representations. Returns None for gain-only or
    analog stages.

    """

    coeffs = None
    fir = _find(stage, "FIR")
    if fir is not None:
        vals = [
            float(c.text) for c in _findall(fir, "NumeratorCoefficient")
        ]
        symmetry = (_text(fir, "Symmetry", "NONE") or "NONE").upper()
        if symmetry == "ODD":
            vals = vals + vals[-2::-1]
        elif symmetry == "EVEN":
            vals = vals + vals[::-1]
        coeffs = vals
    else:
        co = _find(stage, "Coefficients")
        if co is not None:
            num = [float(c.text) for c in _findall(co, "Numerator")]
            den = [float(c.text) for c in _findall(co, "Denominator")]
            if den:
                return None  # IIR coefficient stages not supported
            coeffs = num

    if not coeffs:
        return None

    fs_in, correction = None, None
    dec = _find(stage, "Decimation")
    if dec is not None:
        isr = _text(dec, "InputSampleRate")
        fs_in = float(isr) if isr is not None else None
        corr = _text(dec, "Correction")
        if corr is not None:
            correction = float(corr)
    if fs_in is None:
        return None  # cannot evaluate without the stage's input rate

    return DigitalStage(
        coefficients=np.asarray(coeffs, dtype=np.float64),
        input_sample_rate=fs_in,
        correction=correction,
    )


def read_inventory(path):
    """
    Parse a StationXML file into an :class:`Inventory`. Extracts, for each
    channel epoch, the first PolesZeros response stage (the instrument
    transfer function), the overall InstrumentSensitivity, and every
    digital FIR/Coefficients stage (for full-response removal).

    """

    from .utcdatetime import UTCDateTime

    tree = ET.parse(path)
    root = tree.getroot()

    inv = Inventory()
    for network in _findall(root, "Network"):
        net_code = network.get("code", "")
        for station in _findall(network, "Station"):
            sta_code = station.get("code", "")
            lat = _text(station, "Latitude")
            lon = _text(station, "Longitude")
            elev = _text(station, "Elevation")
            if lat is not None:
                inv.stations[f"{net_code}.{sta_code}"] = {
                    "latitude": float(lat),
                    "longitude": float(lon),
                    "elevation": float(elev) if elev is not None else 0.0,
                }
            for channel in _findall(station, "Channel"):
                cha_code = channel.get("code", "")
                loc_code = channel.get("locationCode", "") or ""
                start = channel.get("startDate")
                end = channel.get("endDate")
                response = _find(channel, "Response")
                if response is None:
                    continue
                sens_elem = _find(response, "InstrumentSensitivity")
                sensitivity = 1.0
                input_units = "M/S"
                if sens_elem is not None:
                    sensitivity = float(_text(sens_elem, "Value", 1.0))
                    iu = _find(sens_elem, "InputUnits")
                    if iu is not None:
                        input_units = _text(iu, "Name", "M/S") or "M/S"

                poles, zeros, a0 = [], [], 1.0
                found_pz = False
                digital_stages = []
                for stage in _findall(response, "Stage"):
                    pz = _find(stage, "PolesZeros")
                    if pz is not None and not found_pz:
                        found_pz = True
                        transfer_type = _text(pz, "PzTransferFunctionType", "")
                        a0 = float(_text(pz, "NormalizationFactor", 1.0))
                        scale = 1.0
                        if "HERTZ" in (transfer_type or "").upper():
                            # Convert rad/s convention: s -> s/(2*pi)
                            scale = 2 * np.pi
                        for p in _findall(pz, "Pole"):
                            re_ = float(_text(p, "Real", 0.0))
                            im = float(_text(p, "Imaginary", 0.0))
                            poles.append(complex(re_, im) * scale)
                        for z in _findall(pz, "Zero"):
                            re_ = float(_text(z, "Real", 0.0))
                            im = float(_text(z, "Imaginary", 0.0))
                            zeros.append(complex(re_, im) * scale)
                        if "HERTZ" in (transfer_type or "").upper():
                            a0 *= (2 * np.pi) ** (len(poles) - len(zeros))
                        continue
                    digital = _parse_digital_stage(stage)
                    if digital is not None:
                        digital_stages.append(digital)

                seed_id = f"{net_code}.{sta_code}.{loc_code}.{cha_code}"
                resp = ChannelResponse(
                    poles=poles,
                    zeros=zeros,
                    normalization_factor=a0,
                    sensitivity=sensitivity,
                    input_units=input_units,
                    start=UTCDateTime(start) if start else None,
                    end=UTCDateTime(end) if end else None,
                    digital_stages=digital_stages,
                )
                inv.responses.setdefault(seed_id, []).append(resp)

    return inv


def paz_for_output(resp, output="VEL"):
    """
    Build the PAZ dict for deconvolving ``resp`` to the requested output
    units, honouring the response's recorded input units (StationXML
    responses are typically w.r.t. velocity, SAC_PZ files w.r.t.
    displacement). Each s-domain zero at the origin differentiates:
    DISP -> VEL -> ACC.

    """

    zeros = list(resp.zeros)
    units = (resp.input_units or "M/S").upper()
    order = {"M": 0, "M/S": 1, "M/S**2": 2, "M/S/S": 2, "M/SEC": 1}.get(units, 1)
    target = {"DISP": 0, "VEL": 1, "ACC": 2}[output.upper()]
    diff = order - target
    if diff > 0:
        zeros.extend([0j] * diff)
    elif diff < 0:
        removed = 0
        for _ in range(-diff):
            if 0j in zeros:
                zeros.remove(0j)
                removed += 1
        if removed < -diff:
            raise ValueError("Cannot convert response units to requested output.")

    return {
        "poles": list(resp.poles),
        "zeros": zeros,
        "gain": resp.normalization_factor,
        "sensitivity": resp.sensitivity,
    }


def remove_trace_response(
    trace, inventory, output="VEL", pre_filt=None, water_level=60.0,
    taper=True, full=False,
):
    """
    Remove the inventory-recorded response from a trace, in place. With
    ``full=True``, the digital FIR/Coefficients stages are deconvolved
    along with the PAZ transfer function.

    """

    resp = inventory.get_response(trace.id, trace.stats.starttime)
    paz = paz_for_output(resp, output)
    trace.data = simulate_seismometer(
        np.asarray(trace.data, dtype=np.float64),
        trace.stats.sampling_rate,
        paz_remove=paz,
        water_level=water_level,
        pre_filt=pre_filt,
        taper=taper,
        stages_remove=resp.digital_stages if full else None,
    )
    return trace
