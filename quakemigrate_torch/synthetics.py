# -*- coding: utf-8 -*-
"""
Synthetic waveform simulation: generate wavelets migrated by a LUT's own
traveltimes, for end-to-end validation of the detect->trigger->locate
pipeline against a known source (the native equivalent of the reference's
examples/synthetic/simulate package). A copy of the JAX package's
``synthetics.py`` on the port's seis, coords and LUT.

"""

from __future__ import annotations

import numpy as np

from quakemigrate_torch.coords import gps2dist_azimuth
from quakemigrate_torch.seis import Stream, Trace, UTCDateTime


class GaussianDerivativeWavelet:
    """First-derivative-of-Gaussian wavelet at a given dominant frequency."""

    def __init__(self, frequency, sps, half_timespan):
        delta_t = 1 / frequency
        sigma = delta_t / 6
        self.frequency = frequency
        self.sps = sps

        self.time = np.arange(-half_timespan, half_timespan + 1 / sps, 1 / sps)
        data = (
            -self.time
            * np.exp(-(self.time**2) / (2 * sigma**2))
            / (sigma**3 * np.sqrt(2 * np.pi))
        )

        # Roll so the first motion sits near the midpoint of the array
        self.data = np.roll(data, int(sps * 0.5 / frequency) + 3) / max(data)


def _attenuate(distance):
    """Hutton-Boore-style logA0 amplitude attenuation with distance (km)."""

    return 1.11 * np.log10(distance / 100.0) + 0.00189 * (distance - 100.0) + 3.0


def _hypo_dist_az_baz(station_data, earthquake_coords, unit_conversion_factor):
    """Hypocentral distance (km) + azimuth/back-azimuth station<->event."""

    stla, stlo, stel = (station_data[k]
                        for k in ("Latitude", "Longitude", "Elevation"))
    evlo, evla, evdp = earthquake_coords

    dist, az, baz = gps2dist_azimuth(evla, evlo, stla, stlo)
    epi_dist = dist / 1000

    km_cf = 1000 / unit_conversion_factor
    z_dist = (evdp - stel) / km_cf

    return np.sqrt(z_dist**2 + epi_dist**2), az, baz


def simulate_waveforms(
    wavelet,
    earthquake_coords,
    lut,
    magnitude=1,
    noise=None,
    angle_of_incidence=0,
    starttime="2021-02-18T12:00:00.0",
    rng=None,
):
    """
    Simulate ZNE waveforms for an earthquake at ``earthquake_coords``
    (lon, lat, depth) using the LUT's own traveltimes: P on the L
    component, S on Q/T, rotated to ZNE via the ray back-azimuth and
    inclination, with distance-attenuated amplitudes and optional Gaussian
    noise on traveltimes and amplitudes.

    """

    if noise is None:
        noise = {
            "traveltime": {"P": 0.02, "S": 0.02},
            "amplitude": {"P": 0.1, "S": 0.1},
        }
    if rng is None:
        rng = np.random.default_rng()

    inclination = 90 - angle_of_incidence
    earthquake_ijk = lut.index2coord(earthquake_coords, inverse=True)

    stream = Stream()
    for station_data in lut.station_data.rows():
        station = station_data["Name"]
        hypo_dist, az, baz = _hypo_dist_az_baz(
            station_data, earthquake_coords, lut.unit_conversion_factor
        )
        amp_factor = 10 ** (magnitude - _attenuate(hypo_dist))

        # L component: P-phase synthetic
        p_ttime = lut.traveltime_to("P", earthquake_ijk, station=station)
        p_ttime = float(np.ravel(p_ttime)[0]) + rng.normal(scale=noise["traveltime"]["P"])
        roll_by = int(wavelet.sps * p_ttime)
        p_noise = rng.normal(
            scale=noise["amplitude"]["P"], size=len(wavelet.data)
        )
        p_data = np.roll(wavelet.data.copy() * amp_factor * 0.5 + p_noise,
                         roll_by)

        # Q/T components: S-phase synthetic
        s_ttime = lut.traveltime_to("S", earthquake_ijk, station=station)
        s_ttime = float(np.ravel(s_ttime)[0]) + rng.normal(scale=noise["traveltime"]["S"])
        roll_by = int(wavelet.sps * s_ttime)
        s_noise = rng.normal(
            scale=noise["amplitude"]["S"], size=len(wavelet.data)
        )
        s1_data = np.roll(wavelet.data.copy() * amp_factor + s_noise, roll_by)
        # Independent draw: reusing s_noise would give Q and T perfectly
        # correlated "noise", skewing SNR/noise statistics downstream
        s2_data = rng.normal(
            scale=noise["amplitude"]["S"], size=len(s1_data)
        )

        lqt_stream = Stream()
        for component, data in zip("LQT", [p_data, s1_data, s2_data]):
            tr = Trace(
                data,
                {
                    "starttime": UTCDateTime(starttime),
                    "sampling_rate": wavelet.sps,
                    "station": station,
                    "network": "SC",
                    "channel": f"CH{component}",
                },
            )
            lqt_stream += tr

        zne_stream = lqt_stream.rotate(
            "LQT->ZNE", back_azimuth=baz, inclination=inclination
        )

        stream += zne_stream

    return stream
