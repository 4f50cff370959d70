# -*- coding: utf-8 -*-
"""
Locate's map path: the plain ``quakemigrate_torch.ops.migrate.migrate_map``
and ``find_max_coa`` against the JAX functions on seeded inputs, M2 (its
CUDA kernel, ``csrc/migrate_marginalise_v2.cu``, and its simple form in
``csrc/migrate_marginalise.cu``) through the plain versions of its
arithmetic on the detect plan, and QuakeScan.locate with
``write_coalescence=True`` on the CPU against the JAX package's map path,
on the synthetic workspace (tests/torch_synthetic.py; both packages run
detect -> trigger -> locate once, module fixture). The kernels run only
on the card: chip_smoke.py holds them to the plain version there.

- the plain migrate_map against JAX's (x64 on float64 inputs; the port in
  float32) within 1e-5 relative, and find_max_coa on the same map within
  1e-5 (the first flat index on ties, as XLA's argmax);
- M2's contract on the plan (the onsets summed in order over each tile's
  base and residuals, exp of the sum times 1 / available, scattered
  through perm) against the plain map within 1e-5, and its per-sample
  max equal, bit for bit, to the max of the detect kernels' plain
  version (their tmax);
- the wrappers raising on CPU tensors and on a plan without fine16,
  and the arguments they hand the kernels;
- locate's map path: the .npy (the 4-D map over the event's window)
  within 1e-5 relative of JAX's and the .event equal to JAX's byte for
  byte; a map over locate_map_memory_limit taking the two-pass path.

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.migrate import find_max_coa as j_find_max_coa
from quakemigrate_tpu.ops.migrate import migrate_map as j_migrate_map
from quakemigrate_torch import _build
from quakemigrate_torch.io import read_coalescence
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.ops.cuda_migrate import (
    CudaDetect,
    CudaDetectVPU,
    DetectPlan,
    combine_tiles,
    migrate_map_cuda,
    migrate_map_v2_cuda,
    plan_acc_chunks,
    reduce_acc_chunks,
)
from quakemigrate_torch.ops.migrate import (
    _prepare_onsets,
    find_max_coa,
    migrate_map,
)

import torch_synthetic as ws

torch.set_num_threads(1)

NODE_COUNT = (9, 8, 7)
N_ONSETS = 6
FSMP, LSMP = 20, 40
RTOL = 1e-5


def _make_inputs(nsamples, seed):
    rng = np.random.default_rng(seed)
    n_nodes = int(np.prod(NODE_COUNT))
    onsets = rng.uniform(0.2, 6.0, size=(N_ONSETS, FSMP + nsamples + LSMP))
    traveltimes = rng.integers(0, LSMP + 1, size=(n_nodes, N_ONSETS))
    mask = np.ones(N_ONSETS)
    mask[3] = 0.0  # one dead onset row
    return {"onsets": onsets, "traveltimes": traveltimes.astype(np.int32),
            "mask": mask, "available": float(mask.sum()),
            "nsamples": nsamples}


def _plain_map(inputs):
    return migrate_map(
        torch.from_numpy(inputs["onsets"].astype(np.float32)),
        torch.from_numpy(inputs["traveltimes"]),
        torch.from_numpy(inputs["mask"].astype(np.float32)),
        inputs["available"], FSMP, inputs["nsamples"], tile=128)


@pytest.mark.parametrize("nsamples", [61, 201])
def test_plain_map_and_find_max_coa_equal_jax(nsamples):
    inputs = _make_inputs(nsamples, 1500 + nsamples)
    got = _plain_map(inputs)
    want = np.asarray(j_migrate_map(
        inputs["onsets"], inputs["traveltimes"], inputs["mask"],
        inputs["available"], FSMP, nsamples, tile=128))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (len(inputs["traveltimes"]), nsamples)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    max_coa, max_coa_n, max_idx = find_max_coa(got)
    j_max, j_max_n, j_idx = (np.asarray(x) for x in j_find_max_coa(want))
    np.testing.assert_allclose(max_coa.numpy(), j_max, rtol=RTOL)
    np.testing.assert_allclose(max_coa_n.numpy(), j_max_n, rtol=RTOL)
    assert max_idx.dtype == torch.int32
    # The same node, or one whose coalescence ties with the max
    at = want[max_idx.numpy(), np.arange(nsamples)]
    np.testing.assert_allclose(at, j_max, rtol=RTOL)


def test_find_max_coa_takes_the_first_node_on_ties():
    coa = torch.tensor([[1.0, 3.0], [2.0, 3.0], [2.0, 1.0]])
    max_coa, max_coa_n, max_idx = find_max_coa(coa)
    assert max_idx.tolist() == [1, 0]
    assert max_coa.tolist() == [2.0, 3.0]
    np.testing.assert_allclose(max_coa_n.numpy(), [6.0 / 5.0, 9.0 / 7.0])
    j_idx = np.asarray(j_find_max_coa(coa.numpy())[2])
    assert j_idx.tolist() == [1, 0]


def _plan_inputs(nsamples, seed, tile=64):
    inputs = _make_inputs(nsamples, seed)
    plan = DetectPlan(inputs["traveltimes"], NODE_COUNT, tile=tile,
                      brick_shape=(4, 4, 4))
    onsets_log = _prepare_onsets(
        torch.from_numpy(inputs["onsets"].astype(np.float32)),
        torch.from_numpy(inputs["mask"].astype(np.float32))).contiguous()
    inv = (1.0 / torch.tensor(inputs["available"],
                              dtype=torch.float32)).reshape(1)
    return inputs, plan, onsets_log, inv


def _m2_on_plan(plan, onsets_log, inv, nsamples):
    """M2's arithmetic on the plan: each real node's onsets summed in
    order over its tile's base and residual, exp of the sum times inv,
    stored at its flat index through perm."""

    out = torch.full((plan.n_nodes, nsamples), np.nan, dtype=torch.float32)
    perm = torch.from_numpy(plan.perm).long()
    valid = torch.from_numpy(plan.valid)
    for c0, acc in plan_acc_chunks(onsets_log, torch.from_numpy(plan.base),
                                   torch.from_numpy(plan.fine), FSMP,
                                   nsamples):
        coa = torch.exp(acc * inv)
        rows = torch.arange(c0 * plan.tile, c0 * plan.tile + coa.numel()
                            // nsamples)
        real = valid[c0:c0 + len(acc)].reshape(-1) != 0
        out[perm[rows][real]] = coa.reshape(-1, nsamples)[real]
    return out


@pytest.mark.parametrize("nsamples", [61, 201])
def test_m2_contract_on_the_plan(nsamples):
    inputs, plan, onsets_log, inv = _plan_inputs(nsamples, 1600 + nsamples)
    got = _m2_on_plan(plan, onsets_log, inv, nsamples)
    assert not torch.isnan(got).any()  # every real node's row written
    np.testing.assert_allclose(got.numpy(), _plain_map(inputs).numpy(),
                               rtol=RTOL, atol=0)
    # The detect kernels' plain version on the same plan: the map's
    # per-sample max is their tmax, bit for bit
    tmax, targ, tsum = reduce_acc_chunks(
        plan_acc_chunks(onsets_log, torch.from_numpy(plan.base),
                        torch.from_numpy(plan.fine), FSMP, nsamples),
        torch.from_numpy(plan.valid), inv)
    max_coa, _, _ = combine_tiles(tmax, targ, tsum,
                                  torch.from_numpy(plan.perm), plan.tile)
    assert torch.equal(got.max(dim=0).values, max_coa)


def test_m2_wrappers_raise_on_cpu_tensors():
    inputs, _, _, _ = _plan_inputs(61, 1700)
    onsets = torch.from_numpy(inputs["onsets"].astype(np.float32))
    mask = torch.from_numpy(inputs["mask"].astype(np.float32))
    for kind in (CudaDetect, CudaDetectVPU):
        detector = kind(inputs["traveltimes"], NODE_COUNT, FSMP, 61, "cpu",
                        tile=64, brick_shape=(4, 4, 4))
        onsets_log, inv = detector.prepare(onsets, mask,
                                           inputs["available"])
        with pytest.raises(ValueError, match="CUDA tensors"):
            detector.map(onsets_log, inv)
    with pytest.raises(ValueError, match="fine16"):
        migrate_map_v2_cuda(onsets_log, detector.base, None, detector.valid,
                            detector.perm, inv, None, 0, FSMP, 61,
                            detector.n_nodes, detector._max_shift)


@pytest.mark.parametrize("v2", [True, False])
def test_m2_wrappers_hand_the_kernel_its_arguments(v2, monkeypatch):
    """The launch is caught, as if the tensors were on the card: the
    C entry, the [n_nodes, nsamples] map and the geometry; and a block
    too short for the plan refused before it."""

    nsamples = 201
    inputs, _, _, _ = _plan_inputs(nsamples, 1800)
    detector = CudaDetect(inputs["traveltimes"], NODE_COUNT, FSMP, nsamples,
                          "cpu", tile=64, brick_shape=(4, 4, 4))
    onsets_log, inv = detector.prepare(
        torch.from_numpy(inputs["onsets"].astype(np.float32)),
        torch.from_numpy(inputs["mask"].astype(np.float32)),
        inputs["available"])
    monkeypatch.setattr(cm, "check_kernel_args", lambda *a, **k: (
        N_ONSETS, onsets_log.shape[1], detector.base.shape[0],
        detector.tile))
    seen = []
    monkeypatch.setattr(cm, "launch_kernel", lambda *a: seen.append(a))
    # the counts of the caught launches go to a copy of the module's
    monkeypatch.setattr(cm, "launches", dict(cm.launches))
    before = dict(cm.launches)
    if v2:
        out = detector.map_m2(onsets_log, inv)
    else:
        out = migrate_map_cuda(onsets_log, detector.base, detector.fine,
                               detector.valid, detector.perm, inv, FSMP,
                               nsamples, detector.n_nodes,
                               detector._max_shift)
    name = "migrate_map_v2" if v2 else "migrate_map"
    assert cm.launches[name] == before[name] + 1
    assert out.shape == (detector.n_nodes, nsamples)
    assert out.dtype == torch.float32
    (args,) = seen
    entry = f"qm_{name}"
    assert args[0] == entry
    # the entry and the device, then every C argument but the stream
    assert len(args) - 2 == len(_build.SIGNATURES[entry]) - 1
    assert args[-2 if v2 else -1] == nsamples
    assert args[-3 if v2 else -2] == FSMP
    with pytest.raises(ValueError, match="too short"):
        migrate_map_cuda(onsets_log[:, :-1].contiguous(), detector.base,
                         detector.fine, detector.valid, detector.perm, inv,
                         FSMP, nsamples, detector.n_nodes,
                         detector._max_shift)


# -- locate's map path --------------------------------------------------------

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return ws.build_workspace(tmp_path_factory.mktemp("torch_map"))


@pytest.fixture(scope="module")
def runs(workspace):
    jax_dir = ws.jax_pipeline(workspace, "jax", write_coalescence=True,
                              write_marginal_coalescence=True)
    seen = []
    port_dir, scan = ws.port_pipeline(workspace, "port", locate=False,
                                      write_coalescence=True,
                                      write_marginal_coalescence=True)
    scan.on_event = lambda event, pass1, handle: seen.append(
        (event, pass1, handle))
    scan.locate(ws.START, ws.END)
    return {"jax": jax_dir, "port": port_dir, "scan": scan, "seen": seen}


def _only(run_dir, kind, suffix):
    files = sorted((run_dir / "locate" / kind).glob(f"*{suffix}"))
    assert len(files) == 1, files
    return files[0]


def test_map_npy_equals_jax(runs, workspace):
    got = read_coalescence(_only(runs["port"], "coalescence_maps", ".npy"))
    want = np.load(_only(runs["jax"], "coalescence_maps", ".npy"))
    assert got.dtype == np.float32
    assert got.shape == want.shape
    assert got.shape[:3] == tuple(workspace["lut"].node_count)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    marg = read_coalescence(_only(runs["port"],
                                  "marginalised_coalescence_maps", ".npy"))
    assert marg.shape == tuple(workspace["lut"].node_count)
    assert marg.max() == 1.0


def test_map_path_event_file_equals_jax(runs):
    got = _only(runs["port"], "events", ".event").read_bytes()
    want = _only(runs["jax"], "events", ".event").read_bytes()
    assert got == want


def test_map_path_keeps_the_map_and_no_pass2(runs):
    scan = runs["scan"]
    assert scan.locate_route == "plain"
    (event, pass1, handle), = runs["seen"]
    assert handle is None
    first, last = event.trim_bounds
    assert event.map4d.shape == tuple(scan.lut.node_count) + (last - first,)
    max_coa, _, max_idx = pass1
    flat = event.map4d.reshape(-1, last - first)
    # pass 1 is the map's own reduction over the window
    np.testing.assert_array_equal(max_coa[first:last], flat.max(axis=0))
    (row,) = scan.locate_event_attrib
    assert row["pass2"] >= 0 and "map_write" in row


def test_map_over_the_memory_limit_takes_two_passes(runs, workspace):
    trigger_file = (runs["port"] / "trigger" / "events"
                    / "port_2021_049_TriggeredEvents.csv")
    scan = ws.port_scan(workspace, "limited", write_coalescence=True,
                        locate_map_memory_limit=1e3)
    seen = []
    scan.on_event = lambda event, pass1, handle: seen.append(handle)
    scan.locate(trigger_file=str(trigger_file))
    out = workspace["root"] / "runs" / "limited" / "locate"
    assert not (out / "coalescence_maps").exists()
    (handle,) = seen
    assert handle is not None  # pass 2 ran
    assert len(list((out / "events").glob("*.event"))) == 1
