# -*- coding: utf-8 -*-
"""Tensor programs of the detect path: onset front end, migration, the
kernels' wrappers and plain versions, and the kernel breakdown; the
JAX package's public device functions of migration, routed by the
tensors' device (:mod:`.routed`: CUDA tensors to the "k3" route's
kernels, CPU tensors to the plain versions); and the STA/LTA onset
functions and signal transform."""

from .routed import (  # noqa: F401
    DEFAULT_TILE,
    detect_reduce,
    find_max_coa,
    migrate_detect,
    migrate_detect_batch,
    migrate_map,
)
from .stalta import (  # noqa: F401
    centred_sta_lta,
    overlapping_sta_lta,
    recursive_sta_lta,
    signal_transform,
)
