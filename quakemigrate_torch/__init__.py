# -*- coding: utf-8 -*-
"""
quakemigrate_torch -- the detect stage of QuakeMigrate on an NVIDIA GPU,
in PyTorch with hand-written CUDA migrate-and-reduce kernels.

A port of the device path of :mod:`quakemigrate_tpu` (the JAX reference,
which it is tested against). It is self-contained: it imports torch,
numpy and scipy, and never jax, pandas, matplotlib or quakemigrate_tpu,
so it runs on a machine that has none of them.

The slice ported so far is continuous detect, from a miniSEED archive to
the ``.scanmseed`` and StationAvailability files (:class:`QuakeScan`):
the host layers (``seis``, ``coords``, ``lut``, ``io``,
``signal.onsets``) read and pre-process each window into a fixed-shape
channel block, and :class:`DetectScan` runs the blocks through the fused
onset front end, the migrate-and-reduce kernel and the normalisation,
window after window. :class:`CudaDetectVPU` is the counterpart of the JAX
``PallasDetect``; ``experiments/`` holds the kernel-breakdown probes.

"""

__version__ = "0.1.0"

from quakemigrate_torch.device import resolve_device  # noqa: F401
from quakemigrate_torch.lut import traveltime_table, unravel  # noqa: F401
from quakemigrate_torch.ops.cuda_migrate import (  # noqa: F401
    CudaDetect,
    CudaDetectVPU,
    DetectPlan,
)
from quakemigrate_torch.signal.scan import DetectScan, QuakeScan  # noqa: F401
