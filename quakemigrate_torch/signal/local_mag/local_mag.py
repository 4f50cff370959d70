# -*- coding: utf-8 -*-
"""
LocalMag ties together the two halves of the magnitude pipeline — amplitude
measurement (:class:`Amplitude`) and magnitude estimation
(:class:`Magnitude`) — behind the single ``calc_magnitude`` entry point that
QuakeScan.locate calls per event (reference:
signal/local_mag/local_mag.py:141-208). The port of the JAX package's
``signal/local_mag/local_mag.py``, host code on the locate post pool.

"""

import logging as _logging

import numpy as np

from quakemigrate_torch.io import write_amplitudes
from quakemigrate_torch.signal.local_mag.amplitude import Amplitude
from quakemigrate_torch.signal.local_mag.magnitude import Magnitude, _isnull
from quakemigrate_torch.util import timeit


class LocalMag:
    """
    Per-event local magnitude driver: measure Wood-Anderson amplitudes,
    estimate per-trace and network-mean ML, write the .amps file, and attach
    the result to the event.

    """

    def __init__(self, amp_params, mag_params, plot_amplitudes=True):
        self.amp, self.mag = Amplitude(amp_params), Magnitude(mag_params)
        self.plot = plot_amplitudes

    def __str__(self):
        parts = [
            "\tCalculating local magnitudes from "
            "Wood-Anderson corrected amplitude observations\n",
            str(self.amp),
            str(self.mag),
        ]
        return "".join(parts)

    @timeit("info")
    def calc_magnitude(self, event, lut, run):
        """
        Full magnitude chain for one located event; returns
        ``(event, network_mean_ML)``. Events with no usable amplitude
        observations get NaN magnitudes but still produce an .amps file.

        """

        observations = self.amp.get_amplitudes(event, lut)

        if _isnull(observations[self.mag.amp_feature]).all():
            _logging.warning(
                "\t\tNo amplitude measurements were made! "
                "Skipping magnitude calculation"
            )
            write_amplitudes(run, observations, event)
            event.add_local_magnitude(*[np.nan] * 3)
            return event, np.nan

        with_mags = self.mag.calculate_magnitudes(observations)
        write_amplitudes(run, with_mags, event)

        network_mag, network_err, r2, with_mags = self.mag.mean_magnitude(with_mags)
        event.add_local_magnitude(network_mag, network_err, r2)

        if self.plot and np.isfinite(network_mag):
            self.mag.plot_amplitudes(
                with_mags, event, run, lut.unit_conversion_factor,
                self.amp.noise_measure,
            )

        return event, network_mag
