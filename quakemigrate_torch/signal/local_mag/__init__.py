# -*- coding: utf-8 -*-
"""
quakemigrate_torch.signal.local_mag -- local magnitude estimation from
Wood-Anderson-corrected waveform amplitudes, the port of the JAX
package's ``signal/local_mag`` without pandas (host code, numpy and
scipy).

"""

from .local_mag import LocalMag  # noqa: F401
from .amplitude import Amplitude  # noqa: F401
from .magnitude import Magnitude  # noqa: F401
