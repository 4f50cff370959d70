# -*- coding: utf-8 -*-
"""
``precision="double"`` in the port against the JAX package on the CPU
(x64 on, tests/conftest.py):

- the plain float64 versions of the kernels of the "k3" route,
  ``detect_reduce``, ``migrate_marginalise``, ``migrate_map`` and
  ``find_max_coa``, against JAX's on numpy-seeded onsets: values within
  1e-12 relative (sums in the same onset order, the marginal window's
  samples summed in another order), the argmax equal wherever the
  maximum is unique (its runner-up more than 1e-10 below it);
- K3 v2 f64's ring on the host: its layout in doubles (windows of
  r + 1 + 128 rounded up to 2, the block's shared memory within one
  block an SM's), its tables, its shape table against the source, and
  a numpy emulation of the kernel on those tables against JAX's
  float64 ``migrate_detect`` with planted ties: max within 1e-12, the
  argmax the first flat index of the tied nodes; the refusal on a span
  the ring of doubles cannot hold (K3 f64) that float32's ring takes;
- the route: "k3" under "double" on a CUDA device type whatever
  ``kernel`` is (nothing touches a card), and the float64 forms chosen
  by the wrappers (their C entries and launch counts, the launch
  caught), the detectors' refusals of a type they have no form for;
- ``QuakeScan.detect``, ``Trigger`` and ``locate`` with
  ``precision="double"`` on the synthetic workspace
  (tests/torch_synthetic.py), fused STA/LTA (two-pass), fused kurtosis
  with the 4-D map (the map path: the .npy within 1e-12 relative of
  JAX's), and the standard path (``fused_detect=False``): the
  .scanmseed's COA and COA_N within one count of JAX's integer scaling,
  X/Y/Z equal, the .event equal byte for byte;
- the reference's own check (its tests/test_scan_variants.py:130-202) in
  the port: the fused and the standard kurtosis detect in double give
  equal .scanmseed files.

"""

import logging
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import migrate as j_migrate
from quakemigrate_torch import _build
from quakemigrate_torch.io import read_coalescence
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.ops import migrate
from quakemigrate_torch.signal.scan import QuakeScan, detect_route

import torch_synthetic as ws
from test_torch_global_v2 import (
    TIE_A, TIE_B, TIE_C, TIE_T0, _f3_like_case, _flat, _k3_v2_emulation)
from test_torch_scan_route import _regional_traveltimes

torch.set_num_threads(1)

RTOL = 1e-12
UNIQUE = 1e-10
CUDA = torch.device("cuda")  # a device type; nothing here touches a card
F64 = torch.float64


def _inputs(seed, n_nodes=700, n_onsets=7, fsmp=30, nsamples=90):
    rng = np.random.default_rng(seed)
    tt = rng.integers(0, 60, size=(n_nodes, n_onsets)).astype(np.int32)
    t_len = fsmp + nsamples + 70
    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, t_len))
    mask = np.ones(n_onsets)
    mask[rng.integers(n_onsets)] = 0.0
    return SimpleNamespace(tt=tt, onsets=onsets, mask=mask,
                           available=float(mask.sum()), fsmp=fsmp,
                           nsamples=nsamples)


def _port(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unique(coa):
    """Samples whose maximum over the nodes (axis 0) is unique: the
    runner-up more than UNIQUE below it, relative."""

    top = np.sort(coa, axis=0)[-2:]
    return top[0] < top[1] * (1 - UNIQUE)


def test_detect_reduce_f64_matches_jax():
    c = _inputs(5)
    got = migrate.detect_reduce(_port(c.onsets), _port(c.tt), _port(c.mask),
                                c.available, c.fsmp, c.nsamples, 650,
                                tile=256)
    want = [np.asarray(x) for x in j_migrate.detect_reduce(
        c.onsets, c.tt, c.mask, c.available, c.fsmp, c.nsamples, 650,
        tile=256)]
    assert all(x.dtype == torch.float64 for x in (got[0], got[2]))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=RTOL, atol=0)
    coa = np.asarray(j_migrate.migrate_map(
        c.onsets, c.tt, c.mask, c.available, c.fsmp, c.nsamples))[:650]
    unique = _unique(coa)
    assert unique.mean() > 0.9
    np.testing.assert_array_equal(got[1].numpy()[unique], want[1][unique])


def test_migrate_map_and_find_max_coa_f64_match_jax():
    c = _inputs(6)
    got = migrate.migrate_map(_port(c.onsets), _port(c.tt), _port(c.mask),
                              c.available, c.fsmp, c.nsamples, tile=256)
    want = np.asarray(j_migrate.migrate_map(
        c.onsets, c.tt, c.mask, c.available, c.fsmp, c.nsamples, tile=256))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    got_max = [x.numpy() for x in migrate.find_max_coa(got)]
    want_max = [np.asarray(x) for x in j_migrate.find_max_coa(want)]
    for a, b in zip(got_max[:2], want_max[:2]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
    unique = _unique(want)
    np.testing.assert_array_equal(got_max[2][unique], want_max[2][unique])


@pytest.mark.parametrize("start, length", [(0, 90), (20, 37), (50, 1)])
def test_migrate_marginalise_f64_matches_jax(start, length):
    c = _inputs(7)
    got = migrate.migrate_marginalise(
        _port(c.onsets), _port(c.tt), _port(c.mask), c.available, c.fsmp,
        c.nsamples, start, length, tile=256)
    want = np.asarray(j_migrate.migrate_marginalise(
        c.onsets, c.tt, c.mask, c.available, c.fsmp, c.nsamples, start,
        length, tile=256))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


# -- K3 v2 f64's ring, tables and emulation -----------------------------------

@pytest.mark.parametrize("geometry", ["f3", "icequake"])
def test_f64_layout_in_doubles(geometry):
    """The f64 ring: shape (16, 8), windows of r + 1 + 128 doubles rounded
    up to 2 at offsets that are multiples of 2, the stage under 2^16
    doubles, the block's bytes the kernel's formula (8-byte windows, 20
    bytes of scratch a warp-sample) within one block an SM's budget."""

    from test_torch_global_v2 import _geometry_spans

    spans = _geometry_spans(geometry)
    lay = cm.global_v2_layout(spans, cm.global_v2_shape(spans, F64),
                              dtype=F64)
    assert lay.shape == (16, 8) and lay.dtype == F64
    widths = cm.global_v2_widths(spans, F64)
    np.testing.assert_array_equal(
        widths, -(-(np.asarray(spans) + 1 + 128) // 2) * 2)
    np.testing.assert_array_equal(lay.win[:, 1], widths)
    assert (lay.win % 2 == 0).all() and lay.stage_floats < 2**16
    stage = -(-(8 * lay.stage_floats + 2 * lay.group * 128) // 128) * 128
    assert lay.smem == lay.n_stages * stage + 20 * 16 * 128 + 16 * (
        lay.n_stages)
    assert lay.smem <= cm.global_v2_budget((16, 8), F64) == cm.SMEM_LIMIT
    for o0 in range(0, len(spans), lay.group):
        ends = (lay.win[o0:o0 + lay.group, 0]
                + lay.win[o0:o0 + lay.group, 1])
        assert ends[-1] <= lay.stage_floats
    f32 = cm.global_v2_layout(spans, cm.global_v2_shape(spans))
    # a ring of doubles holds fewer onsets a stage, or fewer stages
    assert (lay.group, lay.n_stages) <= (f32.group, f32.n_stages)


def test_f64_shapes_match_the_source():
    src = (_build.CSRC_DIR / "migrate_detect_global_v2.cu").read_text()
    line = src[src.index("#define GV_SHAPES_F64(X)"):]
    line = line[:line.index("\n")]
    built = {(int(w), int(n)): int(b)
             for w, n, b in re.findall(r"X\((\d+), (\d+), (\d+)\)", line)}
    assert built == cm.GLOBAL_V2_SHAPES_F64 == cm.global_v2_shapes(F64)


@pytest.mark.parametrize("fsmp", [0, 5, 131])
def test_f64_tables_against_the_plan(fsmp):
    """Each entry, read from its onset's window of doubles (from the
    column rounded down to a multiple of 2), lands on the node's
    traveltime."""

    tt = _regional_traveltimes(node_count=(12, 9, 6))
    plan = cm.DetectPlan(tt, (12, 9, 6))
    lay = cm.global_v2_layout(plan.r_spans, (16, 8), dtype=F64)
    t = cm.global_v2_tables(plan, fsmp, "cpu", lay)
    res = t.res.numpy().astype(np.int64)
    entry = res.transpose(0, 2, 1, 3).reshape(plan.n_tiles, plan.n_onsets,
                                              -1)
    col0 = (fsmp + plan.base) & ~1
    col = col0[:, :, None] + entry - lay.win[None, :, 0, None]
    np.testing.assert_array_equal(
        col, fsmp + plan.base[:, :, None] + plan.fine)


@pytest.mark.parametrize("ties", ["across", "within"])
def test_k3_v2_f64_emulation_matches_jax(ties):
    """The kernel's stages, gather and folds in numpy float64 through the
    f64 tables, on the F3-like grid with planted ties, against JAX's
    float64 migrate_detect: max_coa and max_coa_n within 1e-12, the
    argmax equal where the maximum is unique, and at the planted sample
    the smallest of the tied flat indices."""

    case = _f3_like_case(ties)
    plan = case.plan
    assert cm.global_v2_refusal(plan, F64) is None
    onsets = case.onsets.astype(np.float64)
    logged = np.log(np.clip(onsets, 0.01, None)) * case.mask[:, None]
    lay = cm.global_v2_layout(plan.r_spans, (16, 8), dtype=F64)
    tables = cm.global_v2_tables(plan, case.fsmp, "cpu", lay)
    inv = 1.0 / float(case.available)
    parts = _k3_v2_emulation(logged, plan, tables, inv, case.fsmp,
                             case.nsamples)
    max_coa, max_idx, coa_sum = (x.numpy() for x in cm.combine_brick_tiles(
        *(torch.from_numpy(p) for p in parts[:1]),
        torch.from_numpy(parts[1]).to(torch.int32),
        torch.from_numpy(parts[2])))
    ref = [np.asarray(x) for x in j_migrate.migrate_detect(
        onsets, case.tt, case.mask.astype(np.float64),
        float(case.available), case.fsmp, case.nsamples)]
    assert max_coa.dtype == np.float64
    np.testing.assert_allclose(max_coa, ref[0], rtol=RTOL, atol=0)
    np.testing.assert_allclose(max_coa * case.tt.shape[0] / coa_sum,
                               ref[1], rtol=RTOL, atol=0)
    coa = np.asarray(j_migrate.migrate_map(
        onsets, case.tt, case.mask.astype(np.float64),
        float(case.available), case.fsmp, case.nsamples))
    unique = _unique(coa)
    np.testing.assert_array_equal(max_idx[unique], ref[2][unique])
    tied = [_flat(TIE_A), _flat(TIE_C)] + (
        [_flat(TIE_B)] if ties == "across" else [])
    assert max_idx[TIE_T0] == ref[2][TIE_T0] == min(tied)


def test_f64_refusal_picks_k3_f64(caplog):
    """A 15,000-sample span: float32's ring takes it on the one-block
    shape, the ring of doubles cannot, so "double" runs K3 f64 and logs
    why; CudaDetectGlobal in float64 then keeps no K3 v2 tables."""

    tt = np.zeros((64, 2), np.int32)
    tt[1, 1] = 15_000 - 1
    plan = cm.DetectPlan(tt, (4, 4, 4))
    assert cm.global_v2_refusal(plan) is None
    reason = cm.global_v2_refusal(plan, F64)
    assert reason is not None and "doubles" in reason
    with caplog.at_level(logging.INFO):
        route, why, _ = detect_route(tt, (4, 4, 4), CUDA, "auto", "double")
    assert route == "k3" and why.startswith("precision='double', K3 v3 f64")
    assert "using K3 f64" in caplog.text
    detector = cm.CudaDetectGlobal(tt, (4, 4, 4), 10, 40, "cpu", plan=plan,
                                   dtype=F64)
    assert detector.tables is None and detector.v2_refusal == reason
    # F3's span fits the ring of doubles: K3 v2 f64, no reason logged
    assert detect_route(_regional_traveltimes(), (40, 40, 16), CUDA,
                        precision="double")[:2] == ("k3",
                                                   "precision='double'")


def test_detectors_refuse_a_type_without_a_form():
    tt, nc = _regional_traveltimes(node_count=(8, 8, 4)), (8, 8, 4)
    for kind in (cm.CudaDetect, cm.CudaDetectVPU):
        with pytest.raises(ValueError, match="float64"):
            kind(tt, nc, 10, 40, "cpu", dtype=F64)


def test_k3_f64_detector_on_the_cpu():
    """CudaDetectGlobal in float64 on CPU tensors: its prepared onsets in
    float64 and the plain float64 reduction."""

    c = _inputs(8, n_nodes=8 * 8 * 4)
    tt = c.tt
    detector = cm.CudaDetectGlobal(tt, (8, 8, 4), c.fsmp, c.nsamples, "cpu",
                                   dtype=F64)
    onsets, mask = _port(c.onsets), _port(c.mask)
    onsets_log, inv = detector.prepare(onsets, mask, c.available)
    assert onsets_log.dtype == inv.dtype == F64
    got = detector.reduce(onsets, mask, c.available)
    want = migrate.detect_reduce(onsets, _port(tt), mask, c.available,
                                 c.fsmp, c.nsamples, tt.shape[0])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _plan_case(nsamples=61):
    c = _inputs(9, n_nodes=8 * 8 * 4, nsamples=nsamples)
    detector = cm.CudaDetectGlobal(c.tt, (8, 8, 4), c.fsmp, nsamples, "cpu",
                                   dtype=F64)
    onsets_log, inv = detector.prepare(_port(c.onsets), _port(c.mask),
                                       c.available)
    return detector, onsets_log, inv


def _wide_case(nsamples=61, span=15_000):
    """CudaDetectGlobal in float64 on a 4 x 4 x 4 toy with a residual span
    past K3 v2 f64's ring of doubles (K3 f64's route), and its prepared
    numpy-seeded onsets."""

    tt = np.zeros((64, 2), np.int32)
    tt[1, 1] = span - 1
    detector = cm.CudaDetectGlobal(tt, (4, 4, 4), 10, nsamples, "cpu",
                                   dtype=F64)
    rng = np.random.default_rng(2310)
    onsets = rng.uniform(0.5, 3.0, size=(2, 10 + nsamples + span + 3))
    onsets_log, inv = detector.prepare(_port(onsets), _port(np.ones(2)),
                                       2.0)
    return detector, onsets_log, inv


@pytest.mark.parametrize("path", ["ring", "simple"])
@pytest.mark.parametrize("which", ["marginalise", "map"])
def test_wrappers_launch_the_f64_form(which, path, monkeypatch):
    """Float64 onsets take the f64 C entry and count its launch (the
    launch caught, as if on the card), into float64 outputs: M1 ring f64
    and M2 ring f64 on a plan K3 v2 f64 takes (its tables), M1 f64 and M2
    simple f64 on the wide-span toy K3 v2 f64 refuses."""

    if path == "ring":
        detector, onsets_log, inv = _plan_case()
        assert detector.ring_refusal is None
    else:
        detector, onsets_log, inv = _wide_case()
        assert detector.ring_refusal == detector.v2_refusal
        assert "doubles" in detector.ring_refusal
    seen = []
    monkeypatch.setattr(cm, "launch_kernel", lambda *a: seen.append(a))
    monkeypatch.setattr(cm, "_check_cuda", lambda device: None)
    monkeypatch.setattr(cm, "launches", dict(cm.launches))
    real_check = cm.check_kernel_args

    def on_card(*args, **kwargs):
        # the checks as on the card: the tensors pass, the device is not
        # asked
        try:
            return real_check(*args, **kwargs)
        except ValueError as e:
            if "CUDA tensors" not in str(e):
                raise
            return (onsets_log.shape[0], onsets_log.shape[1],
                    detector.base.shape[0], detector.tile)

    monkeypatch.setattr(cm, "check_kernel_args", on_card)
    ring = "_ring" if path == "ring" else ""
    if which == "marginalise":
        out = detector.marginalise(onsets_log, inv, 3, 40)
        name, shape = f"migrate_marginalise{ring}", (detector.n_nodes,)
    else:
        out = detector.map(onsets_log, inv)
        name, shape = f"migrate_map{ring}", (detector.n_nodes, 61)
    (args,) = seen
    assert args[0] == f"qm_{name}_f64"
    assert len(args) - 2 == len(_build.SIGNATURES[args[0]]) - 1
    assert {k: n for k, n in cm.launches.items() if n} == {f"{name}_f64": 1}
    assert out.dtype == F64 and out.shape == shape


def test_wrappers_refuse_mixed_types():
    """Float64 onsets with a float32 inv_available are refused; K3's
    wrapper takes float64 onsets and inv_available up to the device
    check (a card needed)."""

    detector, onsets_log, inv = _plan_case()
    with pytest.raises(ValueError, match="inv_available"):
        detector.marginalise(onsets_log, inv.float(), 3, 40)
    with pytest.raises(ValueError, match="float64"):
        cm.migrate_detect_global_cuda(onsets_log, detector.tt, inv.float(),
                                      detector.fsmp, 61)
    with pytest.raises(ValueError, match="CUDA"):
        cm.migrate_detect_global_cuda(onsets_log, detector.tt, inv,
                                      detector.fsmp, 61)


@pytest.fixture(scope="module")
def port_lut():
    from quakemigrate_tpu import compute_traveltimes, coords
    from quakemigrate_torch.lut import lut_from_reference

    j_lut = compute_traveltimes(ws.grid_spec(coords), ws.stations_frame(),
                                method="homogeneous", phases=["P", "S"],
                                vp=ws.VP, vs=ws.VS)
    return lut_from_reference(ws.reference_state(j_lut))


@pytest.mark.parametrize("kernel", ["auto", "mxu", "xla"])
def test_double_takes_k3_whatever_the_kernel(kernel, port_lut, caplog,
                                             capsys):
    """On a CUDA device type "double" routes to "k3" for every kernel
    option (decided from the plan's sizes, nothing touches a card), with
    the reference's notice for "mxu"; on the CPU the route is plain."""

    from quakemigrate_torch.signal.onsets import STALTAOnset

    scan = QuakeScan(SimpleNamespace(stations=ws.stations_frame()["Name"]),
                     port_lut, STALTAOnset(sampling_rate=ws.SPS), "runs",
                     "x", device="cpu", kernel=kernel, precision="double")
    assert scan._detect_route()[0] == "plain"
    scan.device, scan._route = CUDA, None
    with caplog.at_level(logging.INFO):
        route, why, _ = scan._detect_route()
    assert route == "k3" and why == "precision='double'"
    # the run's log handler may print it rather than propagate it
    text = caplog.text + capsys.readouterr().out
    assert ("precision='double' keeps the XLA" in text) == (kernel == "mxu")


# -- detect, trigger and locate in double -------------------------------------

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return ws.build_workspace(tmp_path_factory.mktemp("torch_double"))


CASES = {
    "stalta": dict(),
    "kurtosis_map": dict(kurtosis=True, write_coalescence=True),
    "standard": dict(fused_detect=False),
}


@pytest.fixture(scope="module")
def runs(workspace):
    out = {}
    for name, options in CASES.items():
        jax_dir = ws.jax_pipeline(workspace, f"jax_{name}",
                                  precision="double", **options)
        port_dir, scan = ws.port_pipeline(workspace, f"port_{name}",
                                          precision="double", **options)
        out[name] = (jax_dir, port_dir, scan)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_double_scanmseed_matches_jax(runs, case):
    """Within one count of JAX's integer scaling of the float64 values
    (0 relative: float64 rounds the same values to the same integers but
    for a value within a rounding of a half)."""

    jax_dir, port_dir, scan = runs[case]
    assert scan._torch_dtype == F64
    assert scan._fused_active == (case != "standard")
    ws.assert_scanmseed_close(ws.scanmseed_counts(port_dir),
                              ws.scanmseed_counts(jax_dir), 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_double_event_equals_jax(runs, case):
    jax_dir, port_dir, _ = runs[case]
    assert ws.event_rows(port_dir) == ws.event_rows(jax_dir)


def test_double_map_equals_jax(runs):
    jax_dir, port_dir, scan = runs["kurtosis_map"]

    def only(run_dir):
        files = sorted((run_dir / "locate" / "coalescence_maps").glob(
            "*.npy"))
        assert len(files) == 1, files
        return files[0]

    got = read_coalescence(only(port_dir))
    want = np.load(only(jax_dir))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_fused_and_standard_kurtosis_detect_equal(workspace):
    """The reference's check in the port: the fused and the standard
    kurtosis detect in double give equal .scanmseed files."""

    dirs = {}
    for fused in (True, False):
        name = f"kurtosis_{'fused' if fused else 'standard'}"
        dirs[fused], scan = ws.port_pipeline(
            workspace, name, locate=False, kurtosis=True,
            precision="double", fused_detect=fused)
        assert scan._fused_active == fused
    got, want = (ws.scanmseed_counts(dirs[f]) for f in (False, True))
    for name in ("COA", "COA_N", "X", "Y", "Z"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
