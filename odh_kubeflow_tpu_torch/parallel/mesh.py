"""Device-mesh planning and logical-axis sharding rules (counterpart of
odh_kubeflow_tpu/parallel/mesh.py).

The axes and their order are the reference's: ``dp`` (data, params
replicated), ``fsdp`` (data, params sharded ZeRO-style on their "embed"
dim), ``pp`` (pipeline stages), ``ep`` (experts), ``tp`` (heads / mlp
hidden / vocab) and ``sp`` (sequence, ring attention), with tp and sp
innermost. Tensors carry *logical* axis names ("batch", "seq", "embed",
...) that `logical_to_spec` maps onto mesh axes through RULES.

JAX hands the mesh to XLA, which inserts the collectives. Here each process
is one rank of a `torch.distributed` world and runs its own shard:
`MeshPlan.build` places the ranks on the axes in the reference's order and
creates a `dist.new_group` for each tuple of GROUP_AXES that is live, in
that order on every rank (`new_group` is collective): the sp ring; tp, which
the tensor-parallel products sum over; fsdp, which a layer's weights are
gathered over and their gradients reduce-scattered over; (dp, sp), which
the gradients of fsdp-sharded params are then summed over; the replica
(dp, fsdp, sp), which the loss and the gradients of every other param are
summed over; ep, which the experts' outputs and the router's gradients
are summed over; and pp, the pipeline's stage hops, its output broadcast
and its sums over stages (ep and pp appended last, in that order, so the
groups of meshes without a live ep or pp axis keep their order). `Mesh.ranks` names any axes' ranks without a group. A mesh may
hold a sub-group of the world's ranks (`build(ranks=...)`), as a JAX mesh
may hold a subset of the devices: every rank of the world still creates
its groups, and its collectives stay within it. Plain
groups rather than a `DeviceMesh`: a DeviceMesh binds each rank to a
device of its own and creates a communicator per dim for its device type,
and the ranks of a one-card run share one device on the gloo backend.

A `Placement` says where a global tensor lives on the mesh: its spec, and
the segments of a dim whose blocks interleave (the fused QKV projection's
[q | k | v] heads, each rank holding its own q, k and v heads). Its
`pieces` map a rank's local tensor onto global coordinates; the params'
shards (models/convert.py) and the sharded checkpoint (models/checkpoint.py)
are cut and joined through them.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike

AXES: Tuple[str, ...] = ("dp", "fsdp", "pp", "ep", "tp", "sp")

# logical axis -> mesh axis (or tuple of mesh axes). None = replicated.
RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
    "head_dim": None,
    "layers": None,
    "norm": None,
    "expert": "ep",
    "stage": "pp",
}

# the data and sequence axes: the loss and the gradients of params that no
# axis of them shards are summed over these
REPLICA_AXES = ("dp", "fsdp", "sp")
# the data axes besides fsdp: the gradients of fsdp-sharded params, once
# reduce-scattered over fsdp, are summed over these
DATA_SEQ_AXES = ("dp", "sp")
# the axis tuples a mesh makes process groups for, in creation order: the
# ring, the tensor-parallel sums, the ZeRO gathers and reduce-scatters, the
# sharded params' gradient sum, the replica, the expert sums and the
# pipeline's stages
GROUP_AXES = (("sp",), ("tp",), ("fsdp",), DATA_SEQ_AXES, REPLICA_AXES, ("ep",), ("pp",))


@dataclass(frozen=True)
class MeshPlan:
    """Axis sizes for a mesh over the world's ranks."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.fsdp * self.pp * self.ep * self.tp * self.sp

    def sizes(self) -> Dict[str, int]:
        return {axis: getattr(self, axis) for axis in AXES}

    @staticmethod
    def auto(
        n_devices: int,
        want_sp: int = 1,
        want_tp: int = 1,
        want_ep: int = 1,
        want_pp: int = 1,
        prefer_fsdp: bool = True,
    ) -> "MeshPlan":
        """Factor n_devices into mesh axes as the reference does: sp, tp, ep
        and pp in that order each take the largest divisor of what is left
        that does not exceed the wish; the rest goes to fsdp (or dp when
        prefer_fsdp is False). Deterministic and total."""

        def largest_divisor_leq(n: int, cap: int) -> int:
            d = 1
            for c in range(1, min(n, cap) + 1):
                if n % c == 0:
                    d = c
            return d

        rest = n_devices
        sp = largest_divisor_leq(rest, want_sp)
        rest //= sp
        tp = largest_divisor_leq(rest, want_tp)
        rest //= tp
        ep = largest_divisor_leq(rest, want_ep)
        rest //= ep
        pp = largest_divisor_leq(rest, want_pp)
        rest //= pp
        if prefer_fsdp:
            return MeshPlan(dp=1, fsdp=rest, pp=pp, ep=ep, tp=tp, sp=sp)
        return MeshPlan(dp=rest, fsdp=1, pp=pp, ep=ep, tp=tp, sp=sp)

    def build(self, device: DeviceLike = "cuda", ranks: Optional[Sequence[int]] = None) -> Optional["Mesh"]:
        """This rank's `Mesh`. The mesh's ranks — the world's, or `ranks`, a
        sub-group of it, as a JAX mesh may hold a subset of the devices —
        fill the grid (dp, fsdp, pp, ep, tp, sp) in row-major order, so sp
        and then tp are innermost, as the reference's device grid. A plan of
        one device over the whole world needs no process group; otherwise
        torch.distributed must be initialized (parallel.initialize_from_env).
        Every rank of the world must call build, members of `ranks` or not,
        in the same order as its other group creations: `dist.new_group` is
        collective. A rank outside `ranks` gets None. `device` is resolved
        per rank by parallel.rank_device."""
        from .distributed import rank_device

        world, rank = 1, 0
        if dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
        members = list(range(world)) if ranks is None else [int(r) for r in ranks]
        if len(members) != self.n_devices:
            got = f"a world of {world}" if ranks is None else f"ranks {members}"
            raise ValueError(f"MeshPlan{self.sizes()} needs {self.n_devices} ranks, got {got}")
        if len(set(members)) != len(members) or not all(0 <= r < world for r in members):
            raise ValueError(f"ranks {members} are not distinct ranks of a world of {world}")
        mesh = Mesh(self, rank, rank_device(device), members)
        return mesh if rank in members else None


class Mesh:
    """One rank's view of a built MeshPlan: its coordinate on each axis, its
    device, and the process groups of the axes it reduces or rings over.
    `grid` holds the mesh's global ranks at their coordinates; `rank` is
    this process's global rank."""

    def __init__(self, plan: MeshPlan, rank: int, device: torch.device, ranks: Optional[Sequence[int]] = None):
        self.rank = rank
        self.device = device
        self.sizes = plan.sizes()
        self.shape = tuple(self.sizes[a] for a in AXES)
        members = list(range(plan.n_devices)) if ranks is None else list(ranks)
        self.grid = np.asarray(members, dtype=np.int64).reshape(self.shape)
        self._position = {r: i for i, r in enumerate(members)}
        self.coords = self.coords_of(rank) if rank in self._position else None
        # live axes (size > 1) tuple -> (group, ranks of this rank's group)
        self._groups: Dict[Tuple[str, ...], tuple] = {}
        for axes in GROUP_AXES:
            live = self.live(axes)
            if live and live not in self._groups:
                self._groups[live] = self._new_groups(live)

    def live(self, axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
        """The axes of `axes` whose size is above 1, in AXES order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in AXES if a in axes and self.sizes[a] > 1)

    def _rows(self, axes: Tuple[str, ...]):
        """Every set of ranks that differ only along `axes`, each in index
        order."""
        dims = [AXES.index(a) for a in axes]
        rest = [i for i in range(len(AXES)) if i not in dims]
        rows = self.grid.transpose(rest + dims).reshape(-1, int(np.prod([self.shape[d] for d in dims])))
        return [[int(r) for r in row] for row in rows]

    def _new_groups(self, axes: Tuple[str, ...]):
        """A group for every row of `axes` (created on every rank, as
        dist.new_group requires), keeping this rank's."""
        mine = None
        for ranks in self._rows(axes):
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (group, ranks)
        return mine

    def size(self, axes: Union[str, Sequence[str]]) -> int:
        return int(np.prod([self.sizes[a] for a in self.live(axes)], dtype=np.int64))

    def index(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's index along `axes` taken together, row-major in AXES
        order (as the reference's sharding over a tuple of axes)."""
        return axes_index(axes, self.coords, self.sizes)

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of any rank of the mesh (a global rank)."""
        return dict(zip(AXES, (int(i) for i in np.unravel_index(self._position[rank], self.shape))))

    @property
    def world(self) -> int:
        """The mesh's number of ranks."""
        return int(self.grid.size)

    def ranks(self, axes: Union[str, Sequence[str]]) -> list:
        """The global ranks that share this rank's coordinates off `axes`,
        in index order ([this rank] when no axis of them is live)."""
        live = self.live(axes)
        if not live:
            return [self.rank]
        return next(row for row in self._rows(live) if self.rank in row)

    def group(self, axes: Union[str, Sequence[str]]):
        """(process group, its global ranks in index order) of `axes`, or
        (None, [this rank]) when no axis of them is live. Only GROUP_AXES
        have groups."""
        live = self.live(axes)
        if not live:
            return None, [self.rank]
        if live not in self._groups:
            raise KeyError(f"mesh has no group for axes {live}; it builds {sorted(self._groups)}")
        return self._groups[live]


def _axes_of(entry) -> Tuple[str, ...]:
    """A spec entry (None, an axis or a tuple of axes) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_index(axes, coords: Dict[str, int], sizes: Dict[str, int]) -> int:
    """The index along `axes` taken together (live ones, row-major in AXES
    order) of the rank at `coords`."""
    axes = _axes_of(axes)
    idx = 0
    for a in AXES:
        if a in axes and sizes[a] > 1:
            idx = idx * sizes[a] + coords[a]
    return idx


def axes_size(axes, sizes: Dict[str, int]) -> int:
    return int(np.prod([sizes[a] for a in _axes_of(axes)], dtype=np.int64))


@dataclass(frozen=True)
class Placement:
    """Where a global tensor lives on a mesh. `spec` has one entry per dim
    (None, a mesh axis, or a tuple of them; missing trailing entries are
    None), as `logical_to_spec` gives it: the dim is cut into equal blocks
    over those axes, and a rank holds the block at its index. `segments`
    holds (dim, sizes) for a dim made of segments that are each cut so
    (the fused QKV heads [q | k | v]): a rank's block of that dim is its
    block of every segment, in segment order. A tensor replicated on every
    axis is Placement()."""

    spec: tuple = ()
    segments: tuple = ()

    def _dims(self, ndim: int):
        """Per dim: (axes, segment sizes or None)."""
        segs = dict(self.segments)
        return [(_axes_of(self.spec[d]) if d < len(self.spec) else (), segs.get(d)) for d in range(ndim)]

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes that cut the tensor."""
        return tuple(a for entry in self.spec for a in _axes_of(entry))

    def local_shape(self, global_shape, sizes: Dict[str, int]) -> Tuple[int, ...]:
        out = []
        for dim, (axes, segs) in zip(global_shape, self._dims(len(global_shape))):
            n = axes_size(axes, sizes)
            for part in (segs or (dim,)):
                if part % n:
                    raise ValueError(f"a dim of {dim} (segment {part}) does not split over {axes} ({n})")
            out.append(dim // n)
        return tuple(out)

    def global_shape(self, local_shape, sizes: Dict[str, int]) -> Tuple[int, ...]:
        return tuple(sum(segs) if segs else dim * axes_size(axes, sizes)
                     for dim, (axes, segs) in zip(local_shape, self._dims(len(local_shape))))

    def pieces(self, global_shape, coords: Dict[str, int], sizes: Dict[str, int]):
        """[(local offsets, global offsets, shape)]: the boxes of the global
        tensor that the rank at `coords` holds, and where they sit in its
        local tensor."""
        per_dim = []
        for dim, (axes, segs) in zip(global_shape, self._dims(len(global_shape))):
            n, i = axes_size(axes, sizes), axes_index(axes, coords, sizes)
            runs, local, start = [], 0, 0
            for part in (segs or (dim,)):
                runs.append((local, start + i * (part // n), part // n))
                local += part // n
                start += part
            per_dim.append(runs)
        out = []
        for combo in itertools.product(*per_dim):
            out.append((tuple(c[0] for c in combo), tuple(c[1] for c in combo), tuple(c[2] for c in combo)))
        return out

    def writer(self, coords: Dict[str, int], sizes: Dict[str, int]) -> bool:
        """Whether the rank at `coords` writes its block (orbax's replica-0
        rule): its index is 0 on every axis that does not cut the tensor."""
        cut = self.axes()
        return all(coords[a] == 0 for a in AXES if a not in cut)


def logical_to_spec(logical_axes: Sequence[Optional[str]], mesh=None) -> tuple:
    """Translate ("batch", "seq", "embed")-style logical axes into a spec:
    one entry per dim, None (replicated), a mesh axis name, or a tuple of
    them, with mesh axes of size 1 dropped and trailing Nones removed, as
    the reference's PartitionSpec."""
    sizes = mesh.sizes if mesh is not None else None

    def live(axis: Union[str, Tuple[str, ...], None]):
        if axis is None:
            return None
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if sizes is not None:
            axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes

    out = []
    for name in logical_axes:
        if name is None:
            out.append(None)
            continue
        if name not in RULES:
            raise KeyError(f"unknown logical axis {name!r}; known: {sorted(RULES)}")
        out.append(live(RULES[name]))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def data_axes(mesh) -> Tuple[str, ...]:
    """The live mesh axes of an activation's (batch, seq) dims (the axes of
    `logical_to_spec(("batch", "seq", None), mesh)`): the axes a token
    shard's statistics are averaged over, as the reference's
    `_moe_ffn_ep_indexed` averages its aux loss. Their group is the
    replica's (REPLICA_AXES)."""
    out = []
    for entry in logical_to_spec(("batch", "seq", None), mesh):
        out.extend(_axes_of(entry))
    return tuple(out)


def batch_spec(mesh=None, with_seq: bool = True) -> tuple:
    """Spec for a (batch, seq) token array."""
    return logical_to_spec(("batch", "seq") if with_seq else ("batch",), mesh)


def shard_batch(mesh: Mesh, arrays):
    """This rank's block of a dict (nested dicts allowed) of global (batch,
    seq, ...) host arrays (numpy or tensors): the batch split over dp x fsdp
    and the sequence over sp as `logical_to_spec` gives them, moved to the
    rank's device. Integer arrays become int64 tensors. Each split dim must
    divide evenly, as a NamedSharding requires."""

    def block(x):
        t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        if not t.is_floating_point():
            t = t.long()
        spec = logical_to_spec(["batch", "seq"][: t.dim()], mesh)
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            n, i = mesh.size(axes), mesh.index(axes)
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split over {axes} ({n})")
            t = t.narrow(dim, i * (t.shape[dim] // n), t.shape[dim] // n)
        return t.contiguous().to(mesh.device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return block(node)

    return walk(arrays)
