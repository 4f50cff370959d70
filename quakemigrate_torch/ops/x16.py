# -*- coding: utf-8 -*-
"""
The stride table of the TPU experiment ``experiments/exp_x16.py`` and the
detect contract read through it, in plain PyTorch: the plain version of
the shifted-copy kernel (``csrc/migrate_detect_x16.cu``, wrapper
:mod:`quakemigrate_torch.ops.cuda_x16`).

A stride table holds every onset row cut into overlapping rows:
``X[o, a, u] = L[o, fsmp + stride * a + u]``. A node whose shift is
``base + fine`` reads its samples from row ``(base + fine) // stride`` at
column ``(base + fine) % stride + t``. The TPU kernel builds the table
once (stride 16) and rebuilds the shifted operand of its matmul from a
few rows of it; the card keeps four shifted copies of each staged window,
a table of stride 4 in shared memory. The port's plan does not align
``base`` to 16, so the row and column come from ``base + fine`` itself.

"""

import torch

from .cuda_breakdown import _check_tables_fsmp, _slab_acc_chunks
from .cuda_migrate import reduce_acc_chunks


def stride_table(onsets_log, fsmp, n_rows, width, stride):
    """
    ``X[o, a, u] = onsets_log[o, fsmp + stride * a + u]`` for
    ``a < n_rows``, ``u < width``, and 0 past the end of the row. The
    port's copy of the table construction of ``exp_x16.py:186-196``.
    Returns a tensor [O, n_rows, width] of onsets_log's dtype and device.

    """

    t_len = onsets_log.shape[-1]
    device = onsets_log.device
    cols = (fsmp + stride * torch.arange(n_rows, device=device)[:, None]
            + torch.arange(width, device=device)[None, :])
    inside = cols < t_len
    values = onsets_log[:, cols.clamp(max=t_len - 1)]
    return torch.where(inside, values, torch.zeros((), dtype=values.dtype,
                                                    device=device))


def stride_acc_chunks(table, stride, base, fine, nsamples, max_elements=2**23):
    """
    The gather of the detect kernels read through a stride table: yields
    ``(c0, acc)`` for chunks of consecutive tiles, ``acc[c, n, t] =
    sum_o X[o, s // stride, s % stride + t]`` with ``s = base[c0+c, o] +
    fine[c0+c, o, n]``, summed in order o = 0..O-1, each chunk holding at
    most ``max_elements`` values.

    """

    n_tiles, n_onsets, tile = fine.shape
    t = torch.arange(nsamples, device=table.device)
    chunk = max(1, max_elements // (tile * nsamples))
    for c0 in range(0, n_tiles, chunk):
        b = base[c0:c0 + chunk].long()
        f = fine[c0:c0 + chunk].long()
        acc = torch.zeros((b.shape[0], tile, nsamples), dtype=table.dtype,
                          device=table.device)
        for o in range(n_onsets):
            shift = b[:, o, None] + f[:, o, :]
            rows = (shift // stride)[..., None]
            cols = (shift % stride)[..., None] + t
            acc = acc + table[o][rows, cols]
        yield c0, acc


def detect_reduce_stride_reference(onsets_log, base, fine, valid,
                                   inv_available, fsmp, nsamples, stride=16,
                                   max_elements=2**23):
    """
    Plain PyTorch version of the shifted-copy kernel: the detect contract
    (:func:`~quakemigrate_torch.ops.cuda_migrate.detect_reduce_plan_reference`)
    with every onset sample read through the stride table of ``stride``.
    The same values are added in the same order, so the result equals the
    plan reference exactly. Returns (tmax f32, targ int32, tsum f32), each
    [n_tiles, nsamples].

    """

    n_rows = int((base[:, :, None] + fine).max()) // stride + 1
    table = stride_table(onsets_log, fsmp, n_rows, nsamples + stride - 1,
                         stride)
    return reduce_acc_chunks(
        stride_acc_chunks(table, stride, base, fine, nsamples, max_elements),
        valid, inv_available,
    )


def x16_v2_reference(onsets_log, base, valid, inv_available, fsmp, nsamples,
                     tables, max_elements=2**23):
    """
    Plain PyTorch version of E2 v2 (K1's contract) through its tables
    (:func:`~quakemigrate_torch.ops.cuda_x16.x16_v2_tables`): a slab entry
    ``e`` of onset o lies in copy c, the last whose offset ``coff[c, o]``
    is at most e, and reads the window samples from ``u = e - coff[c, o] +
    c``; onset o's window starts at column ``(fsmp + base[i, o]) & ~3``
    (+ s0). Returns (tmax f32, targ int32, tsum f32), each [n_tiles,
    nsamples].

    """

    _check_tables_fsmp(tables, fsmp)
    n_onsets = base.shape[1]
    coff = tables.tab[:4].long()
    entry = tables.slab[..., :n_onsets].long()
    copy = sum((entry >= coff[c]).long() for c in (1, 2, 3))
    u = entry - coff.gather(0, copy.reshape(-1, n_onsets)).reshape(
        entry.shape) + copy
    col0 = (fsmp + base.long()) // 4 * 4
    return reduce_acc_chunks(
        _slab_acc_chunks(onsets_log, col0, u, nsamples, max_elements),
        valid, inv_available,
    )
