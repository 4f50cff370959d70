# -*- coding: utf-8 -*-
"""
The day-scale Icequake detect workload of the kernel experiments: the
71 x 64 x 57 grid at 25 m, 24 onsets (12 P at 3.63 km/s, then 12 S at
1.833 km/s, each from a random surface point), 250 Hz, and gamma-noise
onsets covering ``fsmp + nsamples + lsmp`` samples. Numpy only; seed 0
gives the same arrays as the JAX package's experiments
(``experiments/exp_vmem_sweep.py::workload``).

"""

import numpy as np

NODE_COUNT = (71, 64, 57)
SPACING_KM = 0.025
VP, VS = 3.63, 1.833


def workload(nsamples, n_onsets=24, rate=250.0, fsmp=500):
    """Returns (node_count, traveltimes int32 [N, O], onsets f32 [O, T])."""

    rng = np.random.default_rng(0)
    nx, ny, nz = NODE_COUNT
    x, y, z = np.meshgrid(
        np.arange(nx) * SPACING_KM, np.arange(ny) * SPACING_KM,
        np.arange(nz) * SPACING_KM, indexing="ij",
    )
    tts = []
    for o in range(n_onsets):
        sx = rng.uniform(0, nx * SPACING_KM)
        sy = rng.uniform(0, ny * SPACING_KM)
        v = VP if o < n_onsets // 2 else VS
        tts.append(np.sqrt((x - sx) ** 2 + (y - sy) ** 2 + z**2) / v)
    tt = np.rint(np.stack(tts, -1).reshape(-1, n_onsets) * rate).astype(
        np.int32
    )
    lsmp = int(tt.max()) + 8
    onsets = rng.gamma(
        2.0, 1.5, size=(n_onsets, fsmp + nsamples + lsmp)
    ).astype(np.float32)
    return (nx, ny, nz), tt, onsets
