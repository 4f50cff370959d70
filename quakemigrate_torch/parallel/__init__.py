# -*- coding: utf-8 -*-
"""
quakemigrate_torch.parallel -- the scan engine on a mesh of devices.

Counterpart of quakemigrate_tpu.parallel. The grid's node axis is the
parallel axis: each device of the mesh's "grid" axis owns a slab of grid
nodes (a slab of the traveltime table) and a copy of the onset block,
runs the migrate-and-reduce of its slab, and the per-sample max, argmax
and sum of the slabs are combined. The JAX mesh is one controller's
devices under ``shard_map``, combined by collectives over the ICI; the
port's :class:`Mesh` is an ordered array of ``torch.device`` in one
process, with no ``torch.distributed`` and no NCCL:

- each slab runs on its own device: on the CPU the plain version on a
  flat slab of table rows (:func:`pad_nodes_for_mesh`), as the JAX mesh
  runs its XLA reduction; on a CUDA device the hand kernel of the scan's
  route on a slab of the brick plan's tiles (``DetectPlan.slab``: K1 v2,
  K2 v2 or K3 v2/K3, the route of the whole plan, one for all slabs), as
  the JAX MXU mesh runs its Pallas kernel, or, for a flat table, the
  "k3" route's kernel (``ops.routed``);
- the partial results are copied to the mesh's first device and combined
  there with torch reductions in the JAX order (:func:`combine_slabs`):
  the max, the sum slab by slab, the smallest flat index among the slabs
  attaining the max (the first-index rule), then ``gmax * n_nodes_real /
  gsum``. Nothing of it goes through the host;
- an optional "batch" axis takes windows: window j of a batch of B runs
  on row ``j // (B / n_rows)`` of the mesh, with no combine between rows.

A mesh may name one device more than once: the slabs on it then run in
turn, and the onset front end runs once for it. A slab whose kernel fails
to build or launch raises; no CUDA mesh runs on the CPU.

"""

import numpy as np
import torch

from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.ops import migrate as plain
from quakemigrate_torch.ops import routed
from quakemigrate_torch.ops.cuda_migrate import DetectPlan
from quakemigrate_torch.ops.migrate import DEFAULT_TILE
from quakemigrate_torch.ops.scan_window import (
    kurtosis_front_end,
    onset_front_end,
    stalta_front_end,
)

INT32_MAX = torch.iinfo(torch.int32).max


class Mesh:
    """
    A device mesh: ``devices``, an ndarray of ``torch.device`` whose axes
    are named by ``axis_names``; ``shape`` maps each axis name to its
    size, what the JAX scan reads of a ``jax.sharding.Mesh``.

    """

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"a {devices.ndim}-D device array for the axes "
                             f"{self.axis_names}")
        self.devices = devices

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self):
        """The device the results land on: the first of the mesh."""

        return self.devices.flat[0]

    def rows(self, grid_axis="grid", batch_axis=None):
        """The devices of the grid axis, one list a row of the batch axis
        (one row without it; other axes at their first index)."""

        names = self.axis_names
        if grid_axis not in names:
            raise ValueError(f"the mesh has no {grid_axis!r} axis: {names}")
        keep = [names.index(grid_axis)]
        if batch_axis is not None:
            keep.insert(0, names.index(batch_axis))
        sub = self.devices[tuple(slice(None) if i in keep else 0
                                 for i in range(len(names)))]
        if batch_axis is None:
            sub = sub[None]
        elif keep[0] > keep[1]:
            sub = sub.T
        return [list(row) for row in sub]

    def __repr__(self):
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.ravel()]})")


def _mesh_device(device):
    """A mesh's device: CUDA devices must be present (never the CPU in
    their place)."""

    device = resolve_device(device)
    if device.type == "cuda" and device.index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh device {device} is absent: "
                           f"{torch.cuda.device_count()} CUDA devices")
    return device


def make_mesh(devices=None, axis_names=("grid",), shape=None):
    """
    Build a device mesh. By default a 1-D mesh over every visible CUDA
    device (as ``jax.devices()`` on the card) named "grid"; pass shape +
    axis_names for 2-D ("batch", "grid") layouts. Without CUDA and
    without ``devices`` it raises: a mesh of the CPU is asked for by name
    (``make_mesh([torch.device("cpu")] * 8)``). A device may repeat.

    """

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "the mesh's devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    flat = np.empty(np.size(devices), dtype=object)
    flat[:] = list(np.asarray(devices, dtype=object).ravel())
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (len(flat),)
    return check_mesh(Mesh(flat.reshape(shape), axis_names))


def check_mesh(mesh):
    """``mesh`` with its devices resolved: one device type, and every CUDA
    device present (a CUDA mesh never runs on the CPU). Raises
    otherwise."""

    flat = [_mesh_device(d) for d in mesh.devices.flat]
    if len({d.type for d in flat}) > 1:
        raise ValueError(f"a mesh of one device type, got {flat}")
    mesh.devices.flat[:] = flat
    return mesh


def pad_nodes_for_mesh(traveltimes, n_shards, tile=DEFAULT_TILE):
    """
    Pad the node axis of an [N, O] traveltime table (trailing rows) so it
    divides evenly into ``n_shards`` shards of whole tiles.
    Returns (padded_table, n_real_nodes).

    """

    n = traveltimes.shape[0]
    per_shard = -(-n // (n_shards * tile)) * tile
    pad = per_shard * n_shards - n
    if pad:
        traveltimes = np.pad(traveltimes, ((0, pad), (0, 0)))
    return traveltimes, n


def combine_slabs(parts, n_nodes_real, device):
    """
    The cross-slab reduction of every sharded detect, the counterpart of
    the JAX ``_ici_combine``: each slab's (max, global argmax, sum) [S]
    copied to ``device``; the max over the slabs, the sum added slab by
    slab, and the smallest flat index among the slabs attaining the max.
    Returns (max_coa, max_norm_coa = max_coa * n_nodes_real / sum,
    max_idx int32).

    """

    mx = [p[0].to(device) for p in parts]
    gmax = torch.stack(mx).amax(dim=0)
    gsum = parts[0][2].to(device)
    for p in parts[1:]:
        gsum = gsum + p[2].to(device)
    gidx = torch.stack([torch.where(m == gmax, p[1].to(device), INT32_MAX)
                        for m, p in zip(mx, parts)]).amin(dim=0)
    return gmax, gmax * n_nodes_real / gsum, gidx.to(torch.int32)


def _put(a, device):
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device, non_blocking=True)


class FlatSlab:
    """
    Rows ``[offset, offset + k)`` of a flat traveltime table padded by
    :func:`pad_nodes_for_mesh`: the plain flat-order reduction on the CPU,
    the "k3" route's kernel on a CUDA device (``ops.routed``), global
    indices from ``offset``, rows at or past ``n_nodes_real`` padding.

    """

    def __init__(self, table, offset, n_nodes_real, tile=DEFAULT_TILE):
        self.table = np.ascontiguousarray(table, np.int32)
        self.offset = int(offset)
        self.n_nodes_real = int(n_nodes_real)
        self.tile = tile
        self._tables = {}

    def tensor(self, device):
        """The slab's rows on ``device``, copied there once."""

        if device not in self._tables:
            self._tables[device] = torch.from_numpy(self.table).to(device)
        return self._tables[device]

    @staticmethod
    def prepare(onsets, mask, available, fsmp, nsamples):
        return onsets, mask, available

    def reduce(self, prepared, fsmp, nsamples):
        onsets, mask, available = prepared
        return routed.detect_reduce(
            onsets, self.tensor(onsets.device), mask, available, fsmp,
            nsamples, self.n_nodes_real, self.tile, self.offset)

    def marginalise_rows(self, prepared, fsmp, nsamples, start, length):
        """The marginalisation of each of the slab's rows, padding rows
        included: the plain version on the CPU, the "k3" route's
        marginalisation (M1 ring, or M1 where the ring refuses the plan;
        their f64 forms on float64 onsets) on the plan of the rows on a
        CUDA device."""

        onsets, mask, available = prepared
        tt = self.tensor(onsets.device)
        if not onsets.is_cuda:
            return plain.migrate_marginalise(onsets, tt, mask, available,
                                             fsmp, nsamples, start, length,
                                             self.tile)
        found = routed.detector(tt, tt.shape[0], onsets.shape[-1], fsmp,
                                nsamples, onsets.dtype, onsets.device)
        return found.marginalise(*found.prepare(onsets, mask, available),
                                 start, length)

    def marginalise(self, prepared, fsmp, nsamples, start, length):
        """(values, flat indices) of the slab's real nodes."""

        values = self.marginalise_rows(prepared, fsmp, nsamples, start,
                                       length)
        n = max(0, min(len(self.table), self.n_nodes_real - self.offset))
        nodes = torch.arange(self.offset, self.offset + n,
                             device=values.device)
        return values[:n], nodes


class PlanSlab:
    """
    A slab of a brick plan's tiles (``DetectPlan.slab``): the detector of
    ``route`` (``signal.scan.route_detector``: K1 v2 on "k1_v2", K2 v2 on
    "k2_v2", K3 v2/K3 on "k3", in ``dtype``) on each device of the slab,
    built on first use and kept while the scan geometry holds. On CPU
    tensors a "k1_v2" or "k2_v2" detector runs its plain version.

    """

    def __init__(self, route, plan, dtype=torch.float32):
        self.route = route
        self.plan = plan
        self.dtype = dtype
        self._detectors = {}
        self._nodes = {}

    def detector(self, device, fsmp, nsamples):
        from quakemigrate_torch.signal.scan import route_detector

        self._detectors[device] = route_detector(
            self.route, self.plan, None, None, fsmp, nsamples, device,
            cached=self._detectors.get(device), dtype=self.dtype)
        return self._detectors[device]

    def prepare(self, onsets, mask, available, fsmp, nsamples):
        return self.detector(onsets.device, fsmp, nsamples).prepare(
            onsets, mask, available)

    def reduce(self, prepared, fsmp, nsamples):
        return self.detector(prepared[0].device, fsmp,
                             nsamples).reduce_log(*prepared)

    def marginalise(self, prepared, fsmp, nsamples, start, length):
        """(values, flat indices) of the slab's real nodes: the route's
        marginalisation (M1 v2, M1 ring, or M1; M1 ring f64 on the slab's
        own K3 v2 f64 tables, or M1 f64, in float64) writes the slab's
        nodes of an [n_nodes] buffer (flat indices global), and only those
        are read."""

        device = prepared[0].device
        marginal = self.detector(device, fsmp, nsamples).marginalise(
            *prepared, start, length)
        if device not in self._nodes:
            self._nodes[device] = torch.from_numpy(self.plan.nodes).to(
                device)
        nodes = self._nodes[device]
        return marginal[nodes], nodes


def scan_slabs(mesh, traveltimes, route, plan, tile=DEFAULT_TILE,
               grid_axis="grid", dtype=torch.float32):
    """
    The slabs of a scan's [n_nodes, O] traveltime table on the mesh's
    grid axis: on the "plain" route (a CPU mesh) flat slabs of the table
    padded to whole ``tile``s a slab (:class:`FlatSlab`), as the JAX scan
    pads it; else the route's detectors on slabs of ``plan``'s tiles
    (:class:`PlanSlab`), the tile axis padded with dead tiles.

    """

    n = mesh.shape[grid_axis]
    if route == "plain":
        padded, n_real = pad_nodes_for_mesh(traveltimes, n, tile)
        k = padded.shape[0] // n
        return [FlatSlab(padded[i * k:(i + 1) * k], i * k, n_real, tile)
                for i in range(n)]
    return [PlanSlab(route, slab, dtype) for slab in plan.slabs(n)]


class MeshDetect:
    """
    The sharded migrate-and-reduce of one traveltime table: ``slabs``
    (one a position of the mesh's grid axis) run on the devices of a row
    of the mesh and are combined on its first device.

    """

    def __init__(self, mesh, slabs, n_nodes_real, grid_axis="grid",
                 batch_axis=None):
        self.mesh = mesh
        self.slabs = slabs
        self.n_nodes_real = int(n_nodes_real)
        self.rows = mesh.rows(grid_axis, batch_axis)
        if len(slabs) != len(self.rows[0]):
            raise ValueError(f"{len(slabs)} slabs for a grid axis of "
                             f"{len(self.rows[0])} devices")
        self.device = mesh.first

    def _per_device(self, row, make):
        """``make(device, slab)`` once a distinct device of ``row``, with
        the first slab on it; returns {device: result}."""

        out = {}
        for slab, device in zip(self.slabs, self.rows[row]):
            if device not in out:
                out[device] = make(device, slab)
        return out

    def prepare(self, onsets, mask, available, fsmp, nsamples, row=0):
        """The slabs' inputs of one window's onsets [O, T] on each device
        of ``row``: {device: prepared}."""

        def make(device, slab):
            return slab.prepare(_put(onsets, device), _put(mask, device),
                                available, fsmp, nsamples)
        return self._per_device(row, make)

    def reduce(self, prepared, fsmp, nsamples, row=0):
        """Each slab's reduction of its device's ``prepared`` inputs,
        combined on the first device: (max_coa, max_norm, max_idx)."""

        parts = [slab.reduce(prepared[device], fsmp, nsamples)
                 for slab, device in zip(self.slabs, self.rows[row])]
        return combine_slabs(parts, self.n_nodes_real, self.device)

    def window(self, front_end, block, fsmp, nsamples, row=0, clamp=False):
        """One window of ``front_end``'s ``block`` (its third array the
        slot mask): the front end once a device of ``row``, from the
        block copied there, then :meth:`reduce`. With ``clamp`` the
        window's available count is clamped to 1 (the batched mesh's
        inert pad windows)."""

        def make(device, slab):
            args = tuple(_put(a, device) for a in block)
            combined, available = front_end(*args)
            if clamp:
                available = torch.clamp(torch.as_tensor(
                    available, device=device), min=1.0)
            return slab.prepare(combined, args[2], available, fsmp,
                                nsamples)
        return self.reduce(self._per_device(row, make), fsmp, nsamples, row)

    def batch(self, front_end, block, n_batched, fsmp, nsamples, clamp):
        """A batch of windows: the first ``n_batched`` arrays of ``block``
        carry a leading window axis of B, a multiple of the rows; window
        j runs on row ``j // (B / rows)``. Returns the three outputs,
        each [B, S], on the first device."""

        n_windows = block[0].shape[0]
        if n_windows % len(self.rows):
            raise ValueError(f"{n_windows} windows do not shard over "
                             f"{len(self.rows)} batch rows")
        per = n_windows // len(self.rows)
        outs = [self.window(front_end, tuple(a[j] for a in block[:n_batched])
                            + tuple(block[n_batched:]), fsmp, nsamples,
                            row=j // per, clamp=clamp)
                for j in range(n_windows)]
        return tuple(torch.stack([o[k] for o in outs]) for k in range(3))

    def marginalise(self, prepared, fsmp, nsamples, start, length, row=0):
        """Each slab's marginalisation over ``[start, start + length)``,
        its real nodes written into one [n_nodes_real] result on the
        first device."""

        out = None
        for slab, device in zip(self.slabs, self.rows[row]):
            values, nodes = slab.marginalise(prepared[device], fsmp,
                                             nsamples, start, length)
            if out is None:
                out = torch.empty(self.n_nodes_real, dtype=values.dtype,
                                  device=self.device)
            out[nodes.to(self.device)] = values.to(self.device)
        return out


def _flat_mesh_detect(mesh, traveltimes, n_nodes_real, tile, grid_axis,
                      batch_axis):
    """A MeshDetect of flat slabs of an already padded [N_padded, O]
    table (numpy or a tensor)."""

    if torch.is_tensor(traveltimes):
        traveltimes = traveltimes.detach().cpu().numpy()
    table = np.asarray(traveltimes, np.int32)
    n = mesh.shape[grid_axis]
    if table.shape[0] % n:
        raise ValueError(f"{table.shape[0]} table rows do not divide into "
                         f"{n} shards (pad_nodes_for_mesh)")
    k = table.shape[0] // n
    slabs = [FlatSlab(table[i * k:(i + 1) * k], i * k, n_nodes_real, tile)
             for i in range(n)]
    return MeshDetect(mesh, slabs, n_nodes_real, grid_axis, batch_axis)


def _cached(build):
    """``build(*arrays)`` kept while the same array objects come back (a
    sharded function's table or plan, put on the devices once)."""

    state = {}

    def get(*arrays):
        if state.get("key") is None or any(
                a is not b for a, b in zip(state["key"], arrays)):
            state["key"] = arrays
            state["value"] = build(*arrays)
        return state["value"]
    return get


def _sharded_window(mdetect, front_end, n_block, n_batched, fsmp, nsamples,
                    batch_axis):
    """``f(*block, *tables)``: the first ``n_block`` arguments are a
    window's block (with ``batch_axis``, the first ``n_batched`` of them
    carry the window axis), the rest give the MeshDetect
    (``mdetect(*tables)``)."""

    def f(*args):
        block, tables = args[:n_block], args[n_block:]
        md = mdetect(*tables)
        if batch_axis is None:
            return md.window(front_end, block, fsmp, nsamples)
        return md.batch(front_end, block, n_batched, fsmp, nsamples,
                        clamp=True)
    return f


def make_sharded_detect(
    mesh, fsmp, nsamples, n_nodes_real, tile=DEFAULT_TILE, grid_axis="grid",
    batch_axis=None,
):
    """
    The mesh-sharded fused migrate+reduce. The returned function has
    signature ``f(onsets, traveltimes, mask, available) -> (max_coa,
    max_norm, idx)``, tensors on the mesh's first device, where
    ``traveltimes`` [N_padded, O] splits into flat slabs over
    ``grid_axis`` (N_padded must divide evenly; see
    :func:`pad_nodes_for_mesh`): the plain reduction on CPU devices, the
    "k3" route's kernel (K3 v2, or K3) on CUDA devices.

    If ``batch_axis`` is given, ``onsets`` gains a leading batch dimension
    [B, O, T] sharded over that axis (with mask/available [B, O] / [B]),
    and the outputs gain a matching leading dimension -- data parallelism
    over scan windows on top of grid parallelism.

    """

    mdetect = _cached(lambda tt: _flat_mesh_detect(
        mesh, tt, n_nodes_real, tile, grid_axis, batch_axis))
    front_end = onset_front_end()

    def f(onsets, traveltimes, mask, available):
        md = mdetect(traveltimes)
        if batch_axis is None:
            return md.window(front_end, (onsets, available, mask), fsmp,
                             nsamples)
        return md.batch(front_end, (onsets, available, mask), 3, fsmp,
                        nsamples, clamp=False)
    return f


def make_sharded_marginalise(
    mesh, fsmp, nsamples, tile=DEFAULT_TILE, grid_axis="grid",
):
    """
    The mesh-sharded window marginalisation -- the second pass of the
    two-pass locate. Each device marginalises its own slab of grid nodes
    over the sample window ``[window_start, window_start +
    window_length)``; the outputs concatenate along the node axis.

    The returned function has signature ``f(onsets, traveltimes, mask,
    available, window_start, window_length) -> coa_3d_flat [N_padded]``
    on the mesh's first device, where ``traveltimes`` [N_padded, O] is
    split over ``grid_axis`` (N_padded must divide evenly; see
    :func:`pad_nodes_for_mesh`) -- the caller drops the padded tail rows.
    The plain version runs on CPU devices, the "k3" route's
    marginalisation (M1 ring, or M1; their f64 forms on float64 onsets)
    on CUDA devices.

    """

    mdetect = _cached(lambda tt: _flat_mesh_detect(
        mesh, tt, tt.shape[0], tile, grid_axis, None))

    def f(onsets, traveltimes, mask, available, window_start,
          window_length):
        md = mdetect(traveltimes)
        parts = []
        for slab, device in zip(md.slabs, md.rows[0]):
            prepared = (_put(onsets, device), _put(mask, device), available)
            parts.append(slab.marginalise_rows(
                prepared, fsmp, nsamples, int(window_start),
                int(window_length)).to(md.device))
        return torch.cat(parts)
    return f


def make_sharded_detect_fused(
    mesh, position, transform, min_onset_value, fsmp, nsamples,
    n_nodes_real, tile=DEFAULT_TILE, grid_axis="grid", batch_axis=None,
):
    """
    Mesh-sharded version of :func:`ops.scan_window.detect_window_fused`:
    the whole detect window (signal transform -> STA/LTA -> RMS combine
    -> clip -> migrate -> reduce) over the device mesh. The onset front
    end runs once a device from the block copied there; the migration
    splits over ``grid_axis``. Signature: ``f(channels, chan_mask,
    slot_mask, nsta, nlta, traveltimes_padded) -> (max_coa,
    max_norm_coa, max_idx)``, with ``traveltimes_padded`` from
    :func:`pad_nodes_for_mesh`.

    With ``batch_axis``, channels/chan_mask/slot_mask gain a leading
    window-batch dimension sharded over that axis (nsta/nlta and the
    traveltimes are shared across windows), and the outputs gain a
    matching leading dimension. Inert pad windows (all-ones channels,
    zero masks) keep the batch size fixed; their ``available`` is clamped
    to 1 so the normalisation never divides by zero.

    """

    return _sharded_window(
        _cached(lambda tt: _flat_mesh_detect(
            mesh, tt, n_nodes_real, tile, grid_axis, batch_axis)),
        stalta_front_end(position, transform, min_onset_value), 5, 3, fsmp,
        nsamples, batch_axis)


def make_sharded_detect_fused_kurtosis(
    mesh, nsmooth, taper_pad, min_onset_value, fsmp, nsamples,
    n_nodes_real, tile=DEFAULT_TILE, grid_axis="grid", batch_axis=None,
):
    """
    Mesh-sharded version of
    :func:`ops.scan_window.detect_window_fused_kurtosis`: the whole
    kurtosis detect window over the device mesh (onset front end once a
    device, migration sharded). Signature:
    ``f(channels, chan_mask, slot_mask, nkurt, traveltimes_padded)``.
    ``batch_axis`` as in :func:`make_sharded_detect_fused`.

    """

    return _sharded_window(
        _cached(lambda tt: _flat_mesh_detect(
            mesh, tt, n_nodes_real, tile, grid_axis, batch_axis)),
        kurtosis_front_end(nsmooth, taper_pad, min_onset_value), 4, 3, fsmp,
        nsamples, batch_axis)


def pad_mxu_plan_for_mesh(kernel, n_shards):
    """
    Split a :class:`~quakemigrate_torch.ops.cuda_migrate.CudaDetect`'s
    brick plan across mesh shards: the tile axis is padded with dead
    tiles (valid=0, base/fine/perm=0) so it divides evenly. Returns
    host-side ``(fine, base, valid, perm)`` (``fine`` the plan's int32
    [n_tiles, O, tile] residuals, ``perm`` flat) ready to split over
    their leading axis. Dead tiles are zeroed by the valid mask, so they
    never win the combine.

    """

    plan = kernel.plan
    fine, base, valid = plan.fine, plan.base, plan.valid
    perm = plan.perm.reshape(plan.n_tiles, plan.tile)
    pad = (-plan.n_tiles) % n_shards
    if pad:
        fine = np.pad(fine, ((0, pad), (0, 0), (0, 0)))
        base = np.pad(base, ((0, pad), (0, 0)))
        valid = np.pad(valid, ((0, pad), (0, 0)))
        perm = np.pad(perm, ((0, pad), (0, 0)))
    return fine, base, valid, perm.ravel()


def _plan_mesh_detect(mesh, n_nodes_real, tile, r_spans, grid_axis,
                      batch_axis):
    """``mdetect(fine, base, valid, perm)``: a MeshDetect of the plan's
    tile slabs on the route of the whole plan (on a CPU mesh K1 v2's
    plain version)."""

    def build(fine, base, valid, perm):
        arrays = [a.detach().cpu().numpy() if torch.is_tensor(a) else a
                  for a in (fine, base, valid, perm)]
        plan = DetectPlan.of_tiles(*arrays, n_nodes_real, r_spans)
        if plan.tile != tile:
            raise ValueError(f"tile {tile} for a plan of tile {plan.tile}")
        n = mesh.shape[grid_axis]
        if plan.n_tiles % n:
            raise ValueError(f"{plan.n_tiles} plan tiles do not divide into "
                             f"{n} shards (pad_mxu_plan_for_mesh)")
        if mesh.first.type == "cuda":
            from quakemigrate_torch.signal.scan import plan_route

            route = plan_route(plan, mesh.first)[0]
        else:
            route = "k1_v2"
        return MeshDetect(mesh, [PlanSlab(route, s) for s in plan.slabs(n)],
                          n_nodes_real, grid_axis, batch_axis)
    return _cached(build)


def make_sharded_detect_fused_mxu(
    mesh, position, transform, min_onset_value, fsmp, nsamples,
    n_nodes_real, tile, r_spans, sblk=None, grid_axis="grid",
    interpret=False, precision="i8x3", batch_axis=None,
):
    """
    Mesh-sharded twin of :func:`make_sharded_detect_fused` on the brick
    plan: each device migrates its slab of plan tiles (from
    :func:`pad_mxu_plan_for_mesh`) with the scan route's kernel of the
    whole plan (K1 v2, K2 v2 or K3 v2/K3; on CPU devices K1 v2's plain
    version), the onset front end once a device, and the per-sample
    max/argmax/sum combined on the first device. Signature:
    ``f(channels, chan_mask, slot_mask, nsta, nlta, fine, base, valid,
    perm) -> (max_coa, max_norm_coa, max_idx)``. ``sblk``, ``interpret``
    and ``precision`` (the TPU kernel's sample block, interpret mode and
    table encoding) are taken and change nothing: the kernels gather the
    onsets in float32.

    ``batch_axis`` as in :func:`make_sharded_detect_fused`.

    """

    return _sharded_window(
        _plan_mesh_detect(mesh, n_nodes_real, tile, r_spans, grid_axis,
                          batch_axis),
        stalta_front_end(position, transform, min_onset_value), 5, 3, fsmp,
        nsamples, batch_axis)


def make_sharded_detect_fused_kurtosis_mxu(
    mesh, nsmooth, taper_pad, min_onset_value, fsmp, nsamples,
    n_nodes_real, tile, r_spans, sblk=None, grid_axis="grid",
    interpret=False, precision="i8x3", batch_axis=None,
):
    """Kurtosis twin of :func:`make_sharded_detect_fused_mxu`. Signature:
    ``f(channels, chan_mask, slot_mask, nkurt, fine, base, valid,
    perm)``."""

    return _sharded_window(
        _plan_mesh_detect(mesh, n_nodes_real, tile, r_spans, grid_axis,
                          batch_axis),
        kurtosis_front_end(nsmooth, taper_pad, min_onset_value), 4, 3, fsmp,
        nsamples, batch_axis)
