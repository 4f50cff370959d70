# -*- coding: utf-8 -*-
"""
E4b v2 of quakemigrate_torch on the CPU: the staging probes redesigned on
E1c v2's TMA ring (``csrc/migrate_detect_probe_v2.cu``, wrapper
``ops.cuda_probe.migrate_detect_probe_v2_cuda``). ``static2``'s plain
version, which gathers through E1c v2's slab and window layout, equals
the plan reference bit for bit (tiles 32, 64 and 512); ``packed``'s
closed form equals the plan reference on all-zero onsets, as does the
gather through the slab of zero windows; the zero table's size and
alignment, the shared-memory sizing and the wrapper's refusals are
checked. The JAX kernel ``_probe_kernel`` (experiments/exp_dma_probe.py)
cannot run on the CPU: it takes no ``interpret`` argument and stages
with TPU DMAs. The CUDA kernel runs only on the card (chip_smoke.py holds
static2 bit for bit to K1 and packed to its closed form).

"""

import pytest
import torch

from quakemigrate_torch.experiments import exp_dma_probe
from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops import cuda_migrate
from quakemigrate_torch.ops import cuda_probe as cp

from test_torch_breakdown import _small_plan

torch.set_num_threads(1)

PLANS = {
    "small": {},
    "padded": {"node_count": (5, 6, 5), "tile": 64, "brick": (4, 4, 4)},
    "onsets11": {"seed": 3, "node_count": (9, 8, 6), "n_onsets": 11},
    "tile512": {"seed": 4, "node_count": (10, 9, 8), "tile": 512,
                "brick": (8, 8, 8)},
}


def _plan(name):
    plan, args, _ = _small_plan(**PLANS[name])
    return plan, args, cb.pipelined_v2_tables(plan, args[5], "cpu")


@pytest.mark.parametrize("name", PLANS)
def test_static2_v2_reference_is_the_plan_reference(name):
    plan, args, tables = _plan(name)
    want = cuda_migrate.detect_reduce_plan_reference(*args)
    got = cp.detect_reduce_probe_v2_reference(args[0], args[1], *args[3:],
                                              tables, "static2")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    with pytest.raises(ValueError, match="unknown mode"):
        cp.detect_reduce_probe_v2_reference(args[0], args[1], *args[3:],
                                            tables, "stream")
    with pytest.raises(ValueError, match="fsmp"):
        cp.detect_reduce_probe_v2_reference(args[0], args[1], *args[3:5],
                                            args[5] + 1, args[6], tables,
                                            "static2")


@pytest.mark.parametrize("name", PLANS)
def test_packed_v2_closed_form_on_zero_onsets(name):
    """With every staged window zero the contract is the closed form: the
    plan reference and the gather through E1c v2's slab on zero onsets
    give it bit for bit (padding nodes too: exp(0) x 0)."""

    plan, args, tables = _plan(name)
    assert (plan.valid == 0).any()  # padding nodes in some tile
    zero_args = (torch.zeros_like(args[0]),) + args[1:]
    want = cuda_migrate.detect_reduce_plan_reference(*zero_args)
    closed = cp.packed_reference(args[3], args[-1])
    probe = cp.detect_reduce_probe_v2_reference(args[0], args[1], *args[3:],
                                                tables, "packed")
    gathered = cb.pipelined_v2_reference(zero_args[0], args[1], *args[3:],
                                         tables)
    for c, p, g, w in zip(closed, probe, gathered, want):
        assert c.dtype == w.dtype and c.shape == w.shape
        assert torch.equal(c, w) and torch.equal(p, w) and torch.equal(g, w)


@pytest.mark.parametrize("nsamples,n_onsets,stride", [
    (300, 24, 192), (625, 24, 192), (30_000, 24, 192), (1, 3, 160),
])
def test_packed_v2_zeros(nsamples, n_onsets, stride):
    """One slot of O x stride floats a sample block, all zero, 16-byte
    aligned: the source of one bulk copy a step."""

    zeros = cp.packed_v2_zeros(nsamples, n_onsets, stride, "cpu")
    n_sblocks = -(-nsamples // cuda_migrate.SBLK)
    assert zeros.dtype == torch.float32 and zeros.is_contiguous()
    assert zeros.numel() == n_sblocks * n_onsets * stride
    assert zeros.data_ptr() % 16 == 0 and not zeros.any()
    # each step's copy starts 16-byte aligned: a slot is whole 16-byte runs
    assert (4 * n_onsets * stride) % 16 == 0


def test_probe_v2_smem_sizing():
    """The C formula (qb_smem_bytes) is E1c v2's at 2 stages: 128 bytes of
    slack, 2 slots of max(O x stride, 3 x 8 x 128) floats, the slab, valid
    and 5 mbarriers; 3 blocks an SM at tile 512 (E4b's plan), 4 at tile
    256."""

    def smem(n_onsets, tile, stride):
        return cb.pipelined_v2_smem(n_onsets, tile, stride, 2)

    assert smem(24, 512, 192) == (
        128 + 2 * 18432 + 24576 + 2048 + 40) == 63656
    assert cb.blocks_that_fit(63656) == 3
    assert smem(24, 256, 192) == 50344
    assert cb.blocks_that_fit(50344) == 4
    assert smem(4, 32, 160) == (
        128 + 2 * 4 * 3 * 8 * 128 + 2 * 32 * 8 + 4 * 32 + 40)
    # E4b's plan: r_span 43, a box of 176 floats at a 192-float stride
    assert cb.pipelined_v2_layout([22] * 12 + [43] * 12) == (192, 176)


def test_probe_v2_wrapper_refuses_what_the_kernel_does_not_take():
    """CPU tensors, an unknown mode and tables of another scan start are
    refused; no plain version runs in the kernel's place, and no launch
    is counted that was not made."""

    plan, args, tables = _plan("small")
    zeros = cp.packed_v2_zeros(args[-1], plan.n_onsets, tables.stride,
                               "cpu")
    cp.reset_launches()
    for mode in cp.PROBE_MODES:
        with pytest.raises(ValueError, match="CUDA tensors"):
            cp.migrate_detect_probe_v2_cuda(args[0], args[1], *args[3:],
                                            tables, mode, zeros)
    with pytest.raises(ValueError, match="unknown mode"):
        cp.migrate_detect_probe_v2_cuda(args[0], args[1], *args[3:], tables,
                                        "deep")
    with pytest.raises(ValueError, match="fsmp"):
        cp.migrate_detect_probe_v2_cuda(args[0], args[1], *args[3:5],
                                        args[5] + 1, args[6], tables,
                                        "static2")
    with pytest.raises(ValueError, match="uint16"):
        bad = type(tables)(**{**vars(tables),
                              "slab": tables.slab.to(torch.int16)})
        cp.migrate_detect_probe_v2_cuda(args[0], args[1], *args[3:], bad,
                                        "static2")
    assert set(cp.launches.values()) == {0}
    assert "migrate_detect_probe_v2" in cp.launches


def test_probe_entry_point_runs_v2_in_turns():
    """E4b v2's modes, E1c v2 at the same plan and v1's modes, in turns;
    the static2 kernel's mangled name for its ptxas report."""

    assert exp_dma_probe.TURNS == ("static2_v2", "packed_v2", "ref_v2",
                                   "static2", "packed")
    assert exp_dma_probe.V2_KERNEL == "qm_probe_v2_kernelILb0E"
    assert cp.PROBE_MODES == ("static2", "packed")
