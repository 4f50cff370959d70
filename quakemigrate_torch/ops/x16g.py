# -*- coding: utf-8 -*-
"""
The stride-16 hi/lo tables of the TPU experiment ``experiments/exp_x16g.py``,
its 16-aligned plan and coarse-select targets, and the detect contract
read through the tables, in plain PyTorch: the plan and plain version of
the tensor-core kernel ``csrc/migrate_detect_x16g.cu`` (wrapper
:mod:`quakemigrate_torch.ops.cuda_x16g`).

The plan is the JAX MXU kernel's (``PallasDetectMXU``): each tile's base
shift is aligned down to 16 and the remainder moves into the residuals,
whose per-onset span is rounded up to 16, so onset o of a tile reads
``A_o = r_o / 16`` consecutive rows of the stride-16 table
``X16[o, a, u] = L[o, fsmp + 16 a + u]``. Each value of the table is
stored as a bf16 pair, ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, so
``|x - hi - lo| <= |x| 2**-17`` (``|x - hi|`` is at most half a bf16
spacing, ``2**(e - 8)`` for ``2**e <= |x|``, and rounding that remainder
leaves at most ``2**(e - 17)``); the contract sums the hi words of the
onsets in order, then the lo words, and adds the two, as the TPU adds
its two products.

"""

import numpy as np
import torch

from quakemigrate_torch.util import round_up
from .cuda_migrate import SBLK, _check_onset_length, reduce_acc_chunks
from .x16 import stride_acc_chunks, stride_table

ALIGN = 16
ABLATIONS = ("full", "nosel", "noonehot", "noexp", "nomain", "noreduce",
             "onlymain")
# Ablations the plain version computes
REFERENCE_ABLATIONS = ("full", "noreduce")
# Ablations that zero an operand of the products (nosel the staged rows,
# noonehot the one-hot A, noexp the Hankel B, onlymain both), so that acc
# is 0 at every node and sample: their outputs have a closed form
ZERO_ACC_ABLATIONS = ("nosel", "noonehot", "noexp", "onlymain")


def align_plan16(plan):
    """
    The 16-aligned plan of a
    :class:`~quakemigrate_torch.ops.cuda_migrate.DetectPlan`, the port's
    copy of ``PallasDetectMXU``'s (``pallas_migrate.py:731-752``):
    ``base16 = base - base % 16``, ``fine16 = fine + base % 16`` and per
    onset ``r16 = max(16, round_up(max fine16 + 1, 16))``. Returns
    (base16 int32 [n_tiles, O], fine16 int32 [n_tiles, O, tile], r_spans16
    tuple).

    """

    remainder = plan.base % ALIGN
    base16 = (plan.base - remainder).astype(np.int32)
    fine16 = (plan.fine + remainder[:, :, None]).astype(np.int32)
    r_spans16 = tuple(
        max(ALIGN, round_up(int(fine16[:, o, :].max()) + 1, ALIGN))
        for o in range(plan.n_onsets)
    )
    return base16, np.ascontiguousarray(fine16), r_spans16


def hilo(x):
    """The bf16 pair of float32 ``x``: ``hi`` rounded to nearest even (as
    ``jax.lax.reduce_precision(x, 8, 7)``) and ``lo = bf16(x - hi)``."""

    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def geometry(t_len, fsmp, nsamples, r_spans16):
    """``(d_max, d_pad, a_pad)`` as ``run_x16g`` computes them
    (``exp_x16g.py:220-223``; ``d_max`` as ``ops/migrate.py:61``): the
    largest shift the onset block allows, the shift rows rounded to 16,
    and the coarse rows per onset rounded to 16."""

    d_max = t_len - fsmp - nsamples
    d_pad = round_up(d_max + 1 + max(r_spans16), ALIGN)
    return d_max, d_pad, round_up(d_pad // ALIGN, ALIGN)


def table_width(nsamples):
    """Columns of a table row: every 128-sample block's columns ``s0 ..
    s0 + 128 + 16``."""

    return round_up(nsamples, SBLK) + ALIGN


def x16g_tables(onsets_log, fsmp, nsamples, r_spans16, max_shift):
    """
    The stride-16 hi/lo tables of the logged onsets ``[O, T]``: (hi, lo),
    each bf16 ``[O * a_pad, table_width(nsamples)]``, and ``a_pad``. Runs
    the onset-length check of the plan's largest shift first, so that
    every row ``base16 / 16 + A_o`` exists.

    """

    _check_onset_length(onsets_log, fsmp, nsamples, max_shift)
    n_onsets, t_len = onsets_log.shape
    _, _, a_pad = geometry(t_len, fsmp, nsamples, r_spans16)
    width = table_width(nsamples)
    x16 = stride_table(onsets_log.float(), fsmp, a_pad, width, ALIGN)
    hi, lo = hilo(x16.reshape(n_onsets * a_pad, width))
    return hi, lo, a_pad


def a_counts(r_spans16):
    """``A_o = r_o / 16``, the coarse rows of each onset."""

    return tuple(r // ALIGN for r in r_spans16)


def a_offsets(r_spans16):
    """Prefix sums of ``A_o``, int32 ``[O + 1]``: coarse row m of the
    staged block belongs to onset o for ``a_off[o] <= m < a_off[o + 1]``."""

    return np.concatenate([[0], np.cumsum(a_counts(r_spans16))]).astype(
        np.int32)


def coarse_targets(base16, r_spans16, a_pad):
    """
    The coarse-select targets of ``run_x16g`` (``exp_x16g.py:236-243``):
    ``want[i, m, 0] = o a_pad + base16[i, o] / 16 + q`` for coarse row m =
    (o, q), -1 on the padding rows up to ``m_pad = round_up(sum A_o, 16)``.
    int32 numpy ``[n_tiles, m_pad, 1]``. Raises if a target lies past the
    onset's ``a_pad`` rows.

    """

    base16 = np.asarray(base16)
    counts = a_counts(r_spans16)
    a_sum = sum(counts)
    o_of_m = np.repeat(np.arange(len(counts)), counts)
    q_of_m = np.concatenate([np.arange(a) for a in counts])
    local = base16[:, o_of_m] // ALIGN + q_of_m[None, :]
    if (local >= a_pad).any():
        raise ValueError(
            f"a coarse row lies past the table's {a_pad} rows an onset; "
            "the onset block is too short for this plan"
        )
    want = np.full((base16.shape[0], round_up(a_sum, ALIGN), 1), -1,
                   np.int32)
    want[:, :a_sum, 0] = o_of_m[None, :] * a_pad + local
    return want


def detect_reduce_x16g_reference(hi, lo, a_pad, base16, fine16, valid,
                                 inv_available, nsamples, ablate="full",
                                 max_elements=2**23):
    """
    Plain PyTorch version of the kernel: per tile and sample, with
    ``acc = sum_o hi[...] + sum_o lo[...]`` (each sum in onset order, in
    float32), the max, first local argmax and sum of ``exp(acc * inv) *
    valid`` (``ablate="full"``), or acc of nodes 0, 1, 2 (``"noreduce"``,
    the middle one as int32). Returns (tmax f32, targ int32, tsum f32),
    each [n_tiles, nsamples].

    """

    if ablate not in REFERENCE_ABLATIONS:
        raise ValueError(f"the plain version computes {REFERENCE_ABLATIONS}, "
                         f"not {ablate!r}")
    n_onsets = base16.shape[1]
    tables = [t.float().reshape(n_onsets, a_pad, t.shape[-1])
              for t in (hi, lo)]
    if ablate == "noreduce":
        fine16 = fine16[:, :, :3].contiguous()

    def chunks():
        pairs = zip(*(stride_acc_chunks(t, ALIGN, base16, fine16, nsamples,
                                        max_elements) for t in tables))
        for (c0, acc_hi), (_, acc_lo) in pairs:
            yield c0, acc_hi + acc_lo

    if ablate == "noreduce":
        acc = torch.cat([a for _, a in chunks()])
        return acc[:, 0], acc[:, 1].to(torch.int32), acc[:, 2]
    return reduce_acc_chunks(chunks(), valid, inv_available)


def zero_acc_reference(valid, nsamples):
    """
    The outputs of an ablation in :data:`ZERO_ACC_ABLATIONS`: with acc = 0
    the coalescence is ``exp(0) * valid = valid``, so per tile and sample
    the max of valid, its first node, and its sum. Returns (tmax f32, targ
    int32, tsum f32), each [n_tiles, nsamples].

    """

    n_tiles = valid.shape[0]
    valid = valid.reshape(n_tiles, -1)
    return tuple(
        x[:, None].expand(n_tiles, nsamples).contiguous()
        for x in (valid.amax(dim=1), valid.argmax(dim=1).to(torch.int32),
                  valid.sum(dim=1))
    )


def coa_at_nodes(hi, lo, a_pad, base16, fine16, valid, inv_available, idx):
    """The contract's coalescence through the hi/lo tables at the local
    node ``idx[tile, t]`` of each tile: f32 ``[n_tiles, S]``, the value
    the plain version computes for that node and sample."""

    n_tiles, n_onsets, _ = fine16.shape
    idx = idx.long()
    t = torch.arange(idx.shape[1], device=idx.device)
    accs = []
    for table in (hi, lo):
        x = table.float().reshape(n_onsets, a_pad, table.shape[-1])
        acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
        for o in range(n_onsets):
            shift = base16[:, o, None].long() + fine16[:, o, :].long().gather(
                1, idx)
            acc = acc + x[o][shift // ALIGN, shift % ALIGN + t]
        accs.append(acc)
    return torch.exp((accs[0] + accs[1]) * inv_available) * valid.gather(1,
                                                                         idx)


def hilo_bound(onsets_log, inv_available):
    """
    The relative bound on a coalescence value read through the hi/lo pair
    against the float32 contract: ``exp(delta) - 1`` with ``delta = inv *
    sum_o max_t |L[o, t]| * (2**-17 + 5 O 2**-24)``: the pair's
    representation (``2**-17``), the float32 onset sums of the contract
    (O roundings) and of the pair (2 O additions, each within ``2**-23``
    if the tensor cores truncate). A float, from the inputs.

    """

    n_onsets = onsets_log.shape[0]
    scale = onsets_log.abs().amax(dim=1).double().sum().item()
    inv = float(inv_available.reshape(-1)[0])
    delta = inv * scale * (2.0**-17 + 5 * n_onsets * 2.0**-24)
    return float(np.expm1(delta))
