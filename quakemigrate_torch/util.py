# -*- coding: utf-8 -*-
"""Small pure helpers shared by the port's modules."""


def time2sample(time, sampling_rate):
    """Seconds -> nearest whole sample count at ``sampling_rate``."""

    return int(round(time * int(sampling_rate)))


def round_up(x, m):
    """Smallest multiple of ``m`` that is >= ``x``."""

    return -(-x // m) * m
