"""Lattice decomposition over a mesh of shards, with a ring halo exchange.

The counterpart of ``multiphase_lbm_tpu/parallel/sharding.py``, with the
same names.  The JAX package is single-controller: one process drives a
``Mesh`` of devices through ``shard_map`` and ring ``lax.ppermute``.  So is
this module.  One process holds the blocks of a lattice, each on its mesh
device, and the ring permute becomes a copy between neighbouring blocks
(``Tensor.to(device, non_blocking=True)`` across devices, a slice on one).
On one card every shard sits on ``cuda:0`` and the shards run one after
another, so there the decomposition adds its exchange, its halo
recomputation and its crop and gains nothing: it measures overhead, not
scaling.  A mesh built with ``devices=`` naming several cards places the
blocks on them; the copies then cross devices.

Paths (as in the JAX package):

* **halo** (:func:`make_halo_step`): exchange a ``width``-cell halo, run an
  *unmodified* global plain step on each halo-extended block, crop.
  Correct for any step whose stencil reach is at most ``width``.
* **fused** (``make_fused_*_step``): the same around the halo-in entries of
  the kernel wrappers (``ops/*_fused.step_fused_halo``), which advance
  ``nsub`` steps per exchange.  1D cuts for every family here (y for SC,
  HCZ, Fakhari and the combustion channel, z for HCZ 3D, x for SC-RT) and
  2D (y × x) cuts for SC and HCZ.  The exchange width is the physical
  ``reach · nsub``: the JAX package rounds it up to 8 rows, a Mosaic
  sublane rule that a CUDA kernel does not have.  The combustion entry also
  takes its shard's global row (:func:`make_fused_combustion_step`), as the
  JAX entry reads ``lax.axis_index``.

Global periodicity rides the ring: the first shard's left neighbour is the
last shard.  Walled axes (SC-RT's y, the walls of a channel mask) are
walls of the model, not of the decomposition, and need nothing here.

Not here: the JAX package's "auto" path, where GSPMD turns the global
step's rolls into collectives (PyTorch's nearest counterpart, DTensor,
needs one process per device); and the pulsatile vessel, which the JAX
package excludes from decomposition too.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops import (_halo, combustion_fused, fakhari_fused, hcz3d_fused,
                   hcz_fused, sc_fused, scrt_fused)

# the mesh axis that cuts each spatial axis, counted from the last
_SPATIAL_AXES = (("x", 1), ("y", 2), ("z", 3))


class Mesh:
    """Devices on a grid with named axes: ``devices`` is a numpy object
    array of ``torch.device`` whose axes are ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> tuple:
        return self.devices.shape

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, devices="
                f"{sorted({str(d) for d in self.devices.flat})})")


def make_mesh(n_devices: int | None = None, shape=None, axis_names=("x",),
              devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards, 1D or of ``shape``.

    ``devices`` defaults to the visible CUDA devices; they are cycled over
    the shards, so one card gives ``n_devices`` shards on ``cuda:0``.
    ``n_devices`` defaults to the number of devices.  Without a visible
    CUDA device and without ``devices`` it raises: it never builds a CPU
    mesh unasked (the CPU tests pass ``[torch.device("cpu")] * n``).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= to "
                "place the shards elsewhere (e.g. [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: devices is empty")
    if n_devices is None:
        n_devices = len(devices)
    if shape is None:
        shape = (n_devices,)
    shape = tuple(shape)
    if n_devices < 1 or math.prod(shape) != n_devices:
        raise ValueError(f"mesh shape {shape} does not hold {n_devices} "
                         "shards")
    grid = np.empty(n_devices, dtype=object)
    for i in range(n_devices):
        grid[i] = devices[i % len(devices)]
    return Mesh(grid.reshape(shape), axis_names)


def lattice_pspec(mesh: Mesh, ndim_spatial: int = 2, leading: int = 1):
    """For each axis of a lattice tensor, the mesh axis that cuts it, or
    None: the last spatial axis along mesh axis 'x', the one before along
    'y', the one before that along 'z', where the mesh has such an axis.
    ``leading`` counts the leading population or component axes, which
    every shard holds whole."""
    spec = [None] * (leading + ndim_spatial)
    for name, pos in _SPATIAL_AXES:
        if name in mesh.axis_names and pos <= ndim_spatial:
            spec[-pos] = name
    return tuple(spec)


class ShardedLattice:
    """A global tensor cut into contiguous blocks over a mesh.

    ``blocks`` is a numpy object array of the mesh's shape: ``blocks[idx]``
    is the block at mesh position ``idx``, on ``mesh.devices[idx]``.
    ``spec[d]`` names the mesh axis that cuts tensor axis ``d`` (None: each
    block holds it whole).  :meth:`gather` joins the blocks again.
    """

    def __init__(self, blocks: np.ndarray, mesh: Mesh, spec: tuple):
        if blocks.shape != mesh.shape:
            raise ValueError(f"blocks {blocks.shape} do not match the mesh "
                             f"{mesh.shape}")
        self.blocks = blocks
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def shape(self) -> tuple:
        """The global shape."""
        local = self.blocks.flat[0].shape
        return tuple(n * (self.mesh.axis_size(a) if a else 1)
                     for n, a in zip(local, self.spec))

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first block's)."""
        dev = (torch.device(device) if device is not None
               else self.blocks.flat[0].device)
        dims = [self.spec.index(a) if a in self.spec else None
                for a in self.mesh.axis_names]

        def join(blocks, k):
            if k == len(dims):
                return blocks.to(dev)
            parts = [join(blocks[i], k + 1) for i in range(len(blocks))]
            return parts[0] if dims[k] is None else torch.cat(parts, dims[k])

        return join(self.blocks, 0)


def shard_lattice(arr: torch.Tensor, mesh: Mesh, leading: int = 1
                  ) -> ShardedLattice:
    """Cut a global tensor into contiguous blocks, each a new tensor on its
    mesh device, along :func:`lattice_pspec`.  Raises when a cut axis does
    not divide over its mesh axis."""
    spec = lattice_pspec(mesh, arr.ndim - leading, leading)
    for d, name in enumerate(spec):
        if name is not None and arr.shape[d] % mesh.axis_size(name):
            raise ValueError(f"axis {d} of size {arr.shape[d]} does not "
                             f"divide over mesh axis {name!r} of "
                             f"{mesh.axis_size(name)} shards")
    blocks = np.empty(mesh.shape, dtype=object)
    for idx in np.ndindex(mesh.shape):
        sl = [slice(None)] * arr.ndim
        for d, name in enumerate(spec):
            if name is not None:
                m = mesh.axis_names.index(name)
                b = arr.shape[d] // mesh.shape[m]
                sl[d] = slice(idx[m] * b, (idx[m] + 1) * b)
        part = arr[tuple(sl)]
        blocks[idx] = torch.empty(part.shape, dtype=arr.dtype,
                                  device=mesh.devices[idx]).copy_(part)
    return ShardedLattice(blocks, mesh, spec)


# ─── halo exchange ─────────────────────────────────────────────────────────
def _exchange_axis(blocks: np.ndarray, width: int, axis: int, axis_name: str,
                   mesh: Mesh) -> np.ndarray:
    """Every block extended by ``width`` cells on each side of tensor axis
    ``axis``, taken from its ring neighbours along mesh axis ``axis_name``:
    the halo on my left is my left neighbour's right edge, the halo on my
    right my right neighbour's left edge, and the ring wraps.  Returns new
    tensors in an object array of the mesh's shape."""
    m = mesh.axis_names.index(axis_name)
    n = mesh.shape[m]
    out = np.empty(blocks.shape, dtype=object)
    for idx in np.ndindex(blocks.shape):
        x = blocks[idx]
        if not 0 <= width <= x.shape[axis]:
            raise ValueError(f"halo width {width} does not fit a block of "
                             f"{x.shape[axis]} cells along axis {axis}")
        left, right = list(idx), list(idx)
        left[m], right[m] = (idx[m] - 1) % n, (idx[m] + 1) % n
        lb, rb = blocks[tuple(left)], blocks[tuple(right)]
        left_halo = lb.narrow(axis, lb.shape[axis] - width, width)
        right_halo = rb.narrow(axis, 0, width)
        out[idx] = torch.cat([left_halo.to(x.device, non_blocking=True), x,
                              right_halo.to(x.device, non_blocking=True)],
                             dim=axis)
    return out


def _halo_width(reach: int, nsub: int) -> int:
    """Exchange width of ``nsub`` steps per exchange: ``reach · nsub``
    cells, what ``nsub`` steps consume.  Not rounded up: the JAX package's
    rounding to 8 rows is Mosaic's sublane alignment."""
    return reach * nsub


def _map(fn: Callable, *arrays: np.ndarray) -> np.ndarray:
    """``fn`` at every mesh position of the object arrays ``arrays``; an
    object array of its results."""
    out = np.empty(arrays[0].shape, dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = fn(*(a[idx] for a in arrays))
    return out


def _blocks_of(state, mesh: Mesh, spec: tuple) -> np.ndarray:
    """The blocks of ``state``, after checking that it is cut over ``mesh``
    as ``spec`` says."""
    if not isinstance(state, ShardedLattice):
        raise TypeError(f"expected a ShardedLattice (shard_lattice), got "
                        f"{type(state).__name__}")
    if state.mesh is not mesh or state.spec != tuple(spec):
        raise ValueError(f"state cut as {state.spec} over {state.mesh}; this "
                         f"step takes {tuple(spec)} over {mesh}")
    return state.blocks


def _require_axes(mesh: Mesh, names: tuple):
    if mesh.axis_names != names:
        raise ValueError(f"this path needs a mesh with axes {names}, got "
                         f"{mesh.axis_names}")


class HaloStep:
    """A decomposed step.  ``exchange(*state)`` returns the halo-extended
    blocks of every state tensor (object arrays in mesh order);
    ``compute(*ext)`` runs the local step on each extended block and
    returns the new state.  Calling the step does both; the two halves are
    separate so that a caller can time the exchange alone."""

    def __init__(self, exchange: Callable, compute: Callable):
        self.exchange = exchange
        self.compute = compute

    def __call__(self, *state):
        return self.compute(*self.exchange(*state))


def make_halo_step(step_fn: Callable, mesh: Mesh, width: int,
                   state_leading: Sequence[int], n_state: int = 1) -> HaloStep:
    """Wrap a *global* step function into a halo-exchange step.

    Args:
      step_fn: ``step_fn(*tensors) -> tensor or tuple``; every argument and
        result is lattice-shaped (spatial axes last).  Index arithmetic or
        rolls inside may wrap at block edges: that reaches only the halo,
        which is cropped.
      mesh: a mesh with axis 'x' and optionally 'y'.
      width: halo width, at least the step's stencil reach.
      state_leading: leading non-spatial axes of each argument.
      n_state: how many leading results are lattice-shaped state; they come
        back cropped as :class:`ShardedLattice`, any others as object arrays
        of the per-block results.

    The step takes :class:`ShardedLattice` arguments.  In 2D it exchanges x
    first and then y on the x-extended blocks, so corner cells arrive from
    the diagonal neighbour in two hops.
    """
    if "x" not in mesh.axis_names or not set(mesh.axis_names) <= {"x", "y"}:
        raise ValueError(f"make_halo_step needs a mesh with axis 'x' and "
                         f"optionally 'y', got {mesh.axis_names}")
    axes = [(name, -pos) for name, pos in _SPATIAL_AXES[:2]
            if name in mesh.axis_names]
    specs = [lattice_pspec(mesh, 2, lead) for lead in state_leading]

    def exchange(*args):
        if len(args) != len(specs):
            raise ValueError(f"expected {len(specs)} arguments, got "
                             f"{len(args)}")
        ext = []
        for a, spec in zip(args, specs):
            blocks = _blocks_of(a, mesh, spec)
            for name, ax in axes:
                blocks = _exchange_axis(blocks, width, len(spec) + ax, name,
                                        mesh)
            ext.append(blocks)
        return ext

    def crop(t):
        for _, ax in axes:
            t = _halo.interior(t, width, t.ndim + ax)
        return t

    def compute(*ext):
        outs = _map(step_fn, *ext)
        single = not isinstance(outs.flat[0], tuple)
        n_out = 1 if single else len(outs.flat[0])
        results = []
        for j in range(n_out):
            part = outs if single else _map(lambda o: o[j], outs)
            if j < n_state:
                part = _map(crop, part)
                results.append(ShardedLattice(
                    part, mesh, lattice_pspec(mesh, 2, part.flat[0].ndim - 2)))
            else:
                results.append(part)
        return results[0] if single else tuple(results)

    return HaloStep(exchange, compute)


def _unzip(outs: np.ndarray, mesh: Mesh, spec: tuple) -> tuple:
    """An object array of per-block tuples as a tuple of ShardedLattice."""
    return tuple(ShardedLattice(_map(lambda o: o[j], outs), mesh, spec)
                 for j in range(len(outs.flat[0])))


def _fused_step(mesh: Mesh, axes: tuple, specs: Sequence[tuple], H: int,
                entry: Callable) -> HaloStep:
    """The decomposed step around a halo-in entry.

    ``axes`` are the mesh axes the path needs, the one the entry crops
    first; ``specs`` the :func:`lattice_pspec` of each state argument, the
    first also that of every result.  Each call extends every argument by
    ``H`` cells on each side of every cut axis (x first, then y on the
    x-extended blocks, so corner cells arrive from the diagonal neighbour in
    two hops), runs ``entry(mesh position, *extended blocks)`` on each
    shard (the position is a tuple in mesh order, JAX's ``axis_index``; an
    entry whose step is the same on every shard ignores it) and crops the
    other cut axes of its results by ``H``.  The entry's kernel wraps its
    index at the extended edges too; that reaches only the cells these
    crops remove."""
    _require_axes(mesh, axes)
    specs = [tuple(s) for s in specs]
    out_spec = specs[0]
    crop_dims = [out_spec.index(a) for a in axes[1:]]

    def exchange(*state):
        if len(state) != len(specs):
            raise ValueError(f"expected {len(specs)} state arguments, got "
                             f"{len(state)}")
        ext = []
        for t, spec in zip(state, specs):
            blocks = _blocks_of(t, mesh, spec)
            for name, _ in _SPATIAL_AXES:
                if name in spec:
                    blocks = _exchange_axis(blocks, H, spec.index(name), name,
                                            mesh)
            ext.append(blocks)
        return tuple(ext)

    def compute(*ext):
        outs = np.empty(ext[0].shape, dtype=object)
        for idx in np.ndindex(outs.shape):
            out = entry(idx, *(e[idx] for e in ext))
            out = out if isinstance(out, tuple) else (out,)
            for d in crop_dims:
                out = tuple(_halo.interior(t, H, d) for t in out)
            outs[idx] = out
        outs = _unzip(outs, mesh, out_spec)
        return outs[0] if len(outs) == 1 else outs

    return HaloStep(exchange, compute)


def make_fused_sc_step(mesh: Mesh, p, nsub: int = 1) -> HaloStep:
    """Fused Shan–Chen step on a y-cut lattice: ring halo exchange of
    ``REACH · nsub`` rows, then the halo-in kernel entry on each shard.

    The mesh has the single axis 'y'; the state is ``(f, fluid_f32)``: the
    ``(9, ny, nx)`` populations and the float32 ``(ny, nx)`` fluid mask, each
    :func:`shard_lattice` over the mesh.  Each call advances ``nsub`` steps
    and returns the new populations.  Global y-periodicity rides the ring.
    """
    H = _halo_width(sc_fused.REACH, nsub)
    return _fused_step(mesh, ("y",), [(None, "y", None), ("y", None)], H,
                       lambda _, f, m: sc_fused.step_fused_halo(
                           f, m, p, nsub=nsub, halo=H))


def make_fused_hcz_step(mesh: Mesh, p, nsub: int = 1) -> HaloStep:
    """Fused HCZ 2D step on a y-cut lattice: state ``(f, g, fluid_f32)``,
    ring exchange of ``3 · nsub`` rows, the halo-in kernel entry on each
    shard; returns the new ``(f, g)`` after ``nsub`` steps.  At the
    single-lattice RTI-2048 setting, nsub = 5, it exchanges 15 rows per
    call."""
    H = _halo_width(hcz_fused.REACH, nsub)
    f_spec = (None, "y", None)
    return _fused_step(mesh, ("y",), [f_spec, f_spec, ("y", None)], H,
                       lambda _, f, g, m: hcz_fused.step_fused_halo(
                           f, g, m, p, nsub=nsub, halo=H))


def make_fused_hcz3d_step(mesh: Mesh, p, nsub: int = 1) -> HaloStep:
    """Fused HCZ 3D (D3Q19) step on a z-cut periodic box: state ``(f, g)``,
    each ``(19, nz, ny, nx)`` cut on z along mesh axis 'z'; ring exchange of
    ``REACH · nsub = 4 · nsub`` z-planes (g reads one plane more a step than
    f; see ``hcz3d_fused.REACH``), then the halo-in kernel entry on each
    shard;
    returns the new ``(f, g)`` after ``nsub`` steps."""
    H = _halo_width(hcz3d_fused.REACH, nsub)
    spec = (None, "z", None, None)
    return _fused_step(mesh, ("z",), [spec, spec], H,
                       lambda _, f, g: hcz3d_fused.step_fused_halo_3d(
                           f, g, p, nsub=nsub, halo=H))


def make_fused_fakhari_step(mesh: Mesh, p, nsub: int = 1) -> HaloStep:
    """Fused Fakhari step on a y-cut periodic lattice: state ``(h, g, u)``,
    ring exchange of ``5 · nsub`` rows, then the halo-in kernel entry on
    each shard; returns the new ``(h, g, u)`` after ``nsub`` steps."""
    H = _halo_width(fakhari_fused.REACH, nsub)
    spec = (None, "y", None)
    return _fused_step(mesh, ("y",), [spec] * 3, H,
                       lambda _, h, g, u: fakhari_fused.step_fused_halo(
                           h, g, u, p, nsub=nsub, halo=H))


def make_fused_sc_step_2d(mesh: Mesh, p, nsub: int = 1) -> HaloStep:
    """Fused Shan–Chen step on a lattice cut on both axes over a (y, x)
    mesh; state ``(f, fluid_f32)`` as in :func:`make_fused_sc_step`.

    Each call exchanges ``2 · nsub`` columns first and then ``2 · nsub``
    rows on the x-extended blocks.  The halo-in entry then runs on each
    shard and crops the rows; the kernel wraps its column index at the
    extended x edges, which reaches only ``2 · nsub`` columns in, and those
    are cropped after it (the argument the 1D paths use for y).  The JAX
    package's 128-column x halo is the Mosaic lane width; any width of at
    least ``2 · nsub`` gives identical results.
    """
    H = _halo_width(sc_fused.REACH, nsub)
    return _fused_step(mesh, ("y", "x"), [(None, "y", "x"), ("y", "x")], H,
                       lambda _, f, m: sc_fused.step_fused_halo(
                           f, m, p, nsub=nsub, halo=H))


def make_fused_hcz_step_2d(mesh: Mesh, p, nsub: int = 1) -> HaloStep:
    """Fused HCZ 2D step on a lattice cut on both axes over a (y, x) mesh
    (see :func:`make_fused_sc_step_2d` for the exchange and the crop); state
    ``(f, g, fluid_f32)``.  One HCZ step consumes 3 cells of halo, so each
    call exchanges ``3 · nsub`` columns and rows."""
    H = _halo_width(hcz_fused.REACH, nsub)
    f_spec = (None, "y", "x")
    return _fused_step(mesh, ("y", "x"), [f_spec, f_spec, ("y", "x")], H,
                       lambda _, f, g, m: hcz_fused.step_fused_halo(
                           f, g, m, p, nsub=nsub, halo=H))


def make_fused_scrt_step(mesh: Mesh, p, nsub: int = 1) -> HaloStep:
    """Fused SC Rayleigh–Taylor step on an x-cut channel: the state ``f`` is
    ``(9, ny, nx)`` in the model's layout, the periodic x axis cut along
    mesh axis 'x' (global x-periodicity rides the ring), the walled y axis
    whole on every shard.  Ring exchange of ``2 · nsub`` columns, then the
    halo-in kernel entry on each shard; returns the new ``f`` after
    ``nsub`` steps.  (The JAX package cuts its transposed, lane-padded
    layout, which is Mosaic's; here no transpose and no ``ny_phys``.)"""
    H = _halo_width(scrt_fused.REACH, nsub)
    return _fused_step(mesh, ("x",), [(None, None, "x")], H,
                       lambda _, f: scrt_fused.step_fused_halo(
                           f, p, nsub=nsub, halo=H))


def make_fused_combustion_step(mesh: Mesh, p, konv: bool = True,
                               nsub: int = 1) -> HaloStep:
    """Fused reactive combustion step on the y-cut channel (or another
    topology of ``p``): the state is the first eight fields of a
    ``CombustionState`` (f, g_O2, g_CO2, g_T, the three forcing terms and
    g_coll), each ``(9, ny, nx)`` :func:`shard_lattice` over a mesh with the
    single axis 'y'; each call exchanges ``REACH · nsub = 4 · nsub`` rows
    of all eight and runs the halo-in kernel entry on each shard, and returns
    the eight new arrays after ``nsub`` steps (without ``konv`` the flow
    only, the other seven unchanged).  ``q_heat`` (GUO2015 only, which the
    kernel refuses) stays outside, as in JAX.

    The channel is walled in y, not periodic: the ring still wraps the two
    edge shards' halos, and the kernel decides every row's boundary role by
    its global row modulo ny, so those halo rows evolve as their global rows
    do in the single-lattice run (which wraps in y too) and the crop
    argument holds unchanged.  Each shard's entry gets its global row
    ``row0 = shard_index · ny_loc − H`` of its extended row 0 and the
    kernel's static inputs of its rows, built once per shard and dtype."""
    H = _halo_width(combustion_fused.REACH, nsub)
    tables = {}

    def entry(idx, *ext):
        ny_ext = ext[0].shape[1]
        row0 = idx[0] * (ny_ext - 2 * H) - H
        key = (idx, ext[0].dtype, ext[0].device)
        if key not in tables:
            tables[key] = combustion_fused.slab_tables(
                p, row0, ny_ext, ext[0].device, ext[0].dtype)
        return combustion_fused.step_fused_halo(ext, tables[key], row0, p,
                                                konv=konv, nsub=nsub, halo=H)

    return _fused_step(mesh, ("y",), [(None, "y", None)] * 8, H, entry)
