# -*- coding: utf-8 -*-
"""Tensor programs of the detect path: onset front end, migration, the
kernels' wrappers and plain versions, and the kernel breakdown."""
