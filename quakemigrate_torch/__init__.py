# -*- coding: utf-8 -*-
"""
quakemigrate_torch -- QuakeMigrate's detect, trigger and locate on an
NVIDIA GPU, in PyTorch with hand-written CUDA migration kernels.

A port of the device path of :mod:`quakemigrate_tpu` (the JAX reference,
which it is tested against). It is self-contained: it imports torch,
numpy and scipy, and never jax, pandas or quakemigrate_tpu, so it runs on
a machine that has none of them. matplotlib is optional: ``plot`` draws
the JAX package's figures with it, imported only when a figure is drawn.

The slices ported so far run from a waveform archive (miniSEED, SAC,
GSE2 or SEG-Y) to the located events, on lookup tables built from
homogeneous, 1-D or 3-D velocity models. Continuous detect (:meth:`QuakeScan.detect`) writes the
``.scanmseed`` and StationAvailability files: the host layers (``seis``,
``coords``, ``lut``, ``io``, ``signal.onsets``) read and pre-process each
window into a fixed-shape channel block, and :class:`DetectScan` runs
the blocks through the fused onset front end, the migrate-and-reduce
kernel and the normalisation, window after window. :class:`Trigger`
thresholds the ``.scanmseed`` into TriggeredEvents files on the host.
:meth:`QuakeScan.locate` re-migrates each triggered event's window on
the card (the detect kernel, then the marginalisation kernel M1 v2; or,
to write the 4-D map, the map kernel M2) and writes its ``.event`` and
``.picks`` files, and with a :class:`~quakemigrate_torch.signal.
local_mag.LocalMag` its local magnitude and ``.amps`` file from
response-corrected Wood-Anderson amplitudes (host code). :class:`CudaDetectVPU` is the
counterpart of the JAX ``PallasDetect``; ``experiments/`` holds the
kernel-breakdown probes.

"""

__version__ = "0.1.0"

from quakemigrate_torch.device import resolve_device  # noqa: F401
from quakemigrate_torch.io import Archive, read_lut, read_stations  # noqa: F401
from quakemigrate_torch.lut import (  # noqa: F401
    LUT,
    compute_traveltimes,
    read_nlloc,
    traveltime_table,
    unravel,
)
from quakemigrate_torch.ops.cuda_migrate import (  # noqa: F401
    CudaDetect,
    CudaDetectGlobal,
    CudaDetectVPU,
    DetectPlan,
)
from quakemigrate_torch.signal import DetectScan, QuakeScan, Trigger  # noqa: F401
