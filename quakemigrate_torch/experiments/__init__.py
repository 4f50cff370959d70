# -*- coding: utf-8 -*-
"""Probes of the CUDA kernels on the card, run as modules
(``python3 -m quakemigrate_torch.experiments.<name>``)."""
