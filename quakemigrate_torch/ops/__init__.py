# -*- coding: utf-8 -*-
"""Tensor programs of the detect path: onset front end, migration, kernel."""
