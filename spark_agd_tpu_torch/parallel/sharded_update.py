"""Cross-replica sharded weight update: reduce-scatter, 1/N prox, gather.

Counterpart of ``spark_agd_tpu/parallel/sharded_update.py`` (arXiv
2004.13336, "Automatic Cross-Replica Sharding of Weight Update in
Data-Parallel Training").  The replicated data-parallel mode
(``parallel.dist_smooth``) combines the full gradient and runs the whole
update (the ``tvec.axpby`` chains, the prox, the curvature sums) on the
full weights.  Here the combine is a reduce-scatter, and everything
between it and the next evaluation runs on the 1/N shard each data slot
received:

    each slot's kernel on its rows -> the slots' sums in slot order
    -> reduce-scatter across processes (Σgrad)   [1/N shard a slot]
    shard-local axpby / prox / z-merge           [1/N of the work]
    scalar sums of f_y, xy_sq, dots, norms       [a few bytes each]
    gather of the shards -> full w for the slots' evaluations

The carry is a tuple with one tree a data slot of this process, each
leaf the slot's flat shard on the slot's device (:class:`ShardLayout`
fixes the geometry: every leaf flattened, zero-padded to a multiple of
N, split evenly).  The pad slots stay inert: ``prox(0, 0, step) == 0``
for every operator of ``ops.prox`` and they add zero to every sum.
``core.agd.run_agd(shard_dot=...)`` takes the loop's dots and norms
through :meth:`ShardLayout.dot`: the slots' partial sums in slot order,
then the processes' in rank order, so every slot and rank takes the same
branches.  Entry and exit speak full trees (the ``AGDResult``'s weights
and ``final_z`` are gathered), so checkpoints and the supervisor's warm
carry cross modes: a generation written by either mode resumes in the
other.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..core import agd, tvec
from ..ops.losses import Gradient
from ..ops.sparse import RowShardedCSR
from . import dist_smooth, mesh as mesh_lib, multihost


class ShardLayout(NamedTuple):
    """The flatten/pad/split geometry of one weight tree over ``n_shards``
    shards (global: the data axis's size across processes).  ``template``
    is a tree of the structure (its leaves are not read)."""

    n_shards: int
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    shard_sizes: Tuple[int, ...]  # ceil(size / n_shards) a leaf
    template: Any

    @classmethod
    def for_tree(cls, tree, n_shards: int) -> "ShardLayout":
        leaves = tvec.leaves(tree)
        shapes = tuple(tuple(leaf.shape) for leaf in leaves)
        sizes = tuple(int(math.prod(s)) for s in shapes)
        shard_sizes = tuple(-(-s // n_shards) for s in sizes)
        return cls(int(n_shards), shapes, sizes, shard_sizes, tree)

    def _padded(self, leaf, size, shard):
        flat = leaf.reshape(-1)
        pad = shard * self.n_shards - size
        return torch.nn.functional.pad(flat, (0, pad)) if pad else flat

    def shard(self, tree, idx: int):
        """Shard ``idx`` (global) of every leaf of ``tree``."""
        out = []
        for leaf, size, shard in zip(tvec.leaves(tree), self.sizes,
                                     self.shard_sizes):
            flat = self._padded(leaf, size, shard)
            out.append(flat[idx * shard:(idx + 1) * shard].clone())
        return tvec.unflatten_like(self.template, iter(out))

    def local(self, tree, mesh: "mesh_lib.Mesh"):
        """The sharded carry of a full ``tree``: this process's shards, a
        tree a data slot, each on its slot's device."""
        first = _first_shard(mesh)
        return tuple(tvec.tmap(lambda a, d=dev: a.to(d),
                               self.shard(tree, first + i))
                     for i, dev in enumerate(mesh.slots()))

    def gather(self, sharded, mesh: "mesh_lib.Mesh"):
        """The full tree of a sharded carry, on the mesh's lead device:
        the slots' shards in slot order, then the processes' in rank
        order (one all-gather a leaf)."""
        lead = mesh.lead
        per_slot = [tvec.leaves(t) for t in sharded]
        out = []
        for j, (shape, size) in enumerate(zip(self.shapes, self.sizes)):
            flat = torch.cat([p[j].to(lead) for p in per_slot])
            if mesh.in_group:
                flat = multihost.all_gather_flat(flat)
            out.append(flat[:size].reshape(shape))
        return tvec.unflatten_like(self.template, iter(out))

    def scatter(self, tree, mesh: "mesh_lib.Mesh"):
        """This process's shards of the ranks' sum of ``tree`` (this
        process's slot-order sum): one reduce-scatter a leaf across
        processes, then each slot's shard on its device."""
        slots = mesh.slots()
        per_leaf = []
        for leaf, size, shard in zip(tvec.leaves(tree), self.sizes,
                                     self.shard_sizes):
            flat = self._padded(leaf, size, shard)
            if mesh.in_group:
                flat = multihost.reduce_scatter_flat(flat)
            per_leaf.append([flat[i * shard:(i + 1) * shard].to(dev)
                             for i, dev in enumerate(slots)])
        return tuple(tvec.unflatten_like(self.template,
                                         iter([p[i] for p in per_leaf]))
                     for i in range(len(slots)))

    def dot(self, a, b, mesh: "mesh_lib.Mesh") -> torch.Tensor:
        """The inner product of two sharded carries: each slot's partial
        dot, added in slot order, then across processes in rank order."""
        parts = [tvec.dot(x, y).reshape(1).cpu() for x, y in zip(a, b)]
        return _scalar_sum(parts, mesh)


def _first_shard(mesh) -> int:
    """The global index of this process's first data slot."""
    if mesh.process_count <= 1:
        return 0
    return multihost.process_index() * len(mesh.slots())


def _scalar_sum(parts, mesh) -> torch.Tensor:
    """The 1-element CPU tensors ``parts`` (one a slot) added in slot
    order, then across processes in rank order: a 0-d tensor."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    if mesh.in_group:
        acc = dist_smooth._join_ranks([acc], kind="scalars")[0]
    return acc.reshape(())


class ShardedUpdateBuild:
    """The ``build`` half of the sharded mode's staged ``(build, dargs)``.

    Not a smooth builder: a stand-alone ``smooth(w)`` cannot keep the
    carry sharded between iterations, so calling it raises.  Consumers
    dispatch on :meth:`make_agd_run` (``api.make_runner`` and the
    supervisor's segment compiler do), whose ``run(carry, data_args)``
    has the replicated step's call shape, so the scheduler's rebalance
    can still swap ``data_args``."""

    def __init__(self, gradient: Gradient, X, y, mask, *,
                 mesh: "mesh_lib.Mesh", data_axis: str):
        self.gradient = gradient
        self.mesh = mesh
        self.data_axis = data_axis
        self.dtype = X.dtype
        self.data_args = tuple(dist_smooth.shard_operands(gradient, X, y,
                                                          mask))

    def __call__(self, *a):
        raise TypeError(
            "sharded-update staged data has no stand-alone smooth: the "
            "carry must stay sharded across iterations, so the whole AGD "
            "loop is built at once; use make_agd_run(prox, reg_value, "
            "config) (api.make_runner and the supervisor do)")

    def make_agd_run(self, prox, reg_value, config: "agd.AGDConfig", *,
                     telemetry_cb: Optional[Callable] = None,
                     poison: bool = False,
                     warm_entry: bool = False) -> Callable:
        """``run(carry, data_args) -> AGDResult`` over full weight trees.

        ``carry`` is ``w0`` (a cold start) or, with ``warm_entry=True``,
        an ``AGDWarmState`` of full trees (the supervisor's resume); the
        sharding and the gathering happen inside.  ``poison=True`` wraps
        the shard smooth with the fault injector (the supervisor's
        drills).  ``reg_value`` is the plain penalty of a tree; the slots'
        values of their shards are added here.  ``telemetry_cb`` is
        ``core.agd.run_agd``'s (the loop runs once for every slot, so it
        is called once an iteration)."""
        mesh, gradient, dtype = self.mesh, self.gradient, self.dtype
        n_shards = mesh.shape[self.data_axis]

        def run(carry, data_args):
            template = carry.x if warm_entry else carry
            layout = ShardLayout.for_tree(template, n_shards)
            if warm_entry:
                warm = carry._replace(x=layout.local(carry.x, mesh),
                                      z=layout.local(carry.z, mesh))
                w0 = warm.x
            else:
                warm = None
                w0 = layout.local(carry, mesh)

            def sums(w_sh):
                w = layout.gather(w_sh, mesh)
                return dist_smooth._slot_sums(gradient, mesh, data_args, w,
                                              dtype, combine=False)

            def smooth(w_sh):
                ls, gs, n = sums(w_sh)
                ls, g_sh, n = dist_smooth.psum_scatter_combine(
                    ls, gs, n, mesh, layout)
                return dist_smooth._finish(ls, g_sh, n)

            def smooth_loss(w_sh):
                ls, _, n = sums(w_sh)
                ls, n = dist_smooth.scalar_combine(ls, n, mesh)
                return ls / n.to(ls.dtype)

            if poison:
                from ..resilience import faults as faults_lib

                smooth = faults_lib.poison_smooth(smooth)

            def prox_sh(w_sh, g_sh, step):
                # elementwise: each slot's shard on its own; the penalty's
                # value is not read by the loop
                return tuple(prox(w, g, step)[0]
                             for w, g in zip(w_sh, g_sh)), None

            def rv_sh(w_sh):
                # elementwise penalties add over elements, and the pad
                # slots add zero: the slots' sum is the full tree's value
                return _scalar_sum([torch.as_tensor(reg_value(w))
                                    .reshape(1).cpu() for w in w_sh], mesh)

            res = agd.run_agd(
                smooth, prox_sh, rv_sh, w0, config, smooth_loss=smooth_loss,
                warm=warm, telemetry_cb=telemetry_cb,
                shard_dot=lambda a, b: layout.dot(a, b, mesh))
            # exit gather: results speak full trees, so checkpoints and a
            # resume in the other mode compose
            return res._replace(weights=layout.gather(res.weights, mesh),
                                final_z=layout.gather(res.final_z, mesh))

        return run


def make_sharded_staged(gradient: Gradient, X, y=None, mask=None, *,
                        mesh: "mesh_lib.Mesh",
                        data_axis: str = mesh_lib.DATA_AXIS):
    """``(build, data_args)`` for the sharded-update mode: the staged twin
    of ``dist_smooth.make_dist_smooth_staged`` with a
    :class:`ShardedUpdateBuild` in the build slot.  Accepts a
    ``ShardedBatch`` (preferred) or raw ``(X, y[, mask])`` sharded on the
    fly.  The fused margin kernel is refused, as the JAX package refuses
    its Pallas kernel in this mode."""
    from ..ops.fused_kernels import FusedMarginGradient

    if isinstance(gradient, FusedMarginGradient):
        raise ValueError(
            "sharded_update does not compose with the fused margin "
            "kernel (the JAX package refuses its Pallas kernel here: its "
            "tile-aligned relayout assumes the replicated smooth "
            "contract); use the plain gradient or sharded_update=False")
    if isinstance(X, mesh_lib.ShardedBatch):
        if y is not None or mask is not None:
            raise ValueError(
                "pass either a ShardedBatch or raw (X, y[, mask]), not both")
        X, y, mask = X
    elif y is None:
        raise ValueError("y is required when X is a raw array")
    mesh_lib.check_data_mesh(mesh, data_axis)
    if not isinstance(X, (mesh_lib.ShardedRows, RowShardedCSR)):
        X, y, mask = mesh_lib.shard_batch(mesh, X, y, mask, axis=data_axis)
    elif X.mesh != mesh:
        raise ValueError("the batch was placed on another mesh than the "
                         "one given; re-shard it or pass its own mesh")
    build = ShardedUpdateBuild(gradient, X, y, mask, mesh=mesh,
                               data_axis=data_axis)
    return build, build.data_args
