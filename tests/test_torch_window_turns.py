# -*- coding: utf-8 -*-
"""
The main path's window-time comparison in turns
(quakemigrate_torch/experiments/window_turns.py) on the CPU: it reads
the warm line that chip_smoke.run_slice prints, and it exits without
CUDA. The timing itself runs only on the card.

"""

import os
import pathlib
import subprocess
import sys

from quakemigrate_torch.experiments import window_turns

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_parse_warm_reads_the_slice_line():
    text = ("slice: window compute 0.8 ms\n"
            "slice (warm): 1.289 ms wall per window, device 1.273 ms median "
            "per window, device busy share 0.989\n"
            "slice (warm): 2.058 ms wall per window, device 1.903 ms median "
            "per window, device busy share 0.956\n")
    assert window_turns.parse_warm(text) == [(1.289, 1.273), (2.058, 1.903)]
    assert window_turns.parse_warm("no slice here") == []
    assert "run_slice" in window_turns._SLICE
    assert "def run_slice(" in (REPO / "chip_smoke.py").read_text()


def test_entry_point_requires_cuda():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "quakemigrate_torch.experiments.window_turns",
         str(REPO), str(REPO)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
