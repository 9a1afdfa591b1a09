"""The mesh and axis registry (the port of `paddle_tpu/distributed/
mesh.py`; ref paddle/fluid/platform/collective_helper.h:65, the ring_id
-> communicator registry).

The JAX package names XLA's device mesh axes; here a mesh is a grid of
`torch.distributed` ranks (rank r sits at the row-major coordinates of r
in the grid), with one process group for every slice along every axis:
the ranks that differ only in that axis' coordinate. Each rank keeps the
groups of the slices it sits in (`Mesh.group(axis)`). A slice of the
whole world is the world's own group; a slice of one rank has none (its
collectives are the identity), unless the world is that one rank. Making
a mesh is collective: every rank makes the same meshes in the same
order.

Axis names, as in the JAX package: 'dp' data parallel | 'mp' tensor
parallel | 'pp' pipeline stages | 'sp' sequence parallel | 'ep' expert
parallel. `PartitionSpec` is the port's placement hint type (a tuple of
axis names or None per dim), the counterpart of jax.sharding's.
"""
import numpy as np
import torch.distributed as dist

_current_mesh = None
_groups = {}          # group id -> _Group
_next_group_id = 1

DP_AXIS = "dp"
MP_AXIS = "mp"
PP_AXIS = "pp"
SP_AXIS = "sp"
EP_AXIS = "ep"


class PartitionSpec(tuple):
    """Placement hint: per dim, a mesh axis name, a tuple of names, or
    None (replicated), as jax.sharding.PartitionSpec spells it."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __reduce__(self):
        # copies and pickles rebuild it from its parts, not one tuple
        return (type(self), tuple(self))

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"



def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A grid of ranks, `{'dp': 2, 'sp': 2}`, and this rank's process
    group along each axis. `shape` maps axis -> size (ordered as given),
    `devices` is the grid of ranks. The mesh covers ranks 0..size-1 of
    the world; a rank past it sits in no slice."""

    def __init__(self, shape_dict):
        self.axis_names = tuple(shape_dict.keys())
        sizes = tuple(int(v) for v in shape_dict.values())
        if not self.axis_names or any(s < 1 for s in sizes):
            raise ValueError(f"bad mesh shape {shape_dict!r}")
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = int(np.prod(sizes))
        world, rank = _world()
        if self.size > world:
            raise ValueError(
                f"mesh {self.shape} needs {self.size} ranks; the world has "
                f"{world}")
        self.devices = np.arange(self.size).reshape(sizes)
        self.rank = rank
        self.coords = None if rank >= self.size else {
            k: int(v) for k, v in zip(self.axis_names,
                                      np.unravel_index(rank, sizes))}
        self._groups = {}           # axis -> (process group or None, ranks)
        for ax, name in enumerate(self.axis_names):
            grid = np.moveaxis(self.devices, ax, -1).reshape(-1, sizes[ax])
            for row in grid:
                ranks = [int(r) for r in row]
                if len(ranks) == world and dist.is_initialized():
                    pg = dist.group.WORLD
                elif len(ranks) == 1:
                    pg = None
                else:
                    pg = dist.new_group(ranks)     # every rank calls it
                if rank in ranks:
                    self._groups[name] = (pg, ranks)

    def __repr__(self):
        return f"Mesh({self.shape})"

    def _entry(self, axis):
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is outside mesh "
                               f"{self.shape}")
        return self._groups[axis]

    def group(self, axis):
        """This rank's process group along `axis` (None for a slice of
        one rank)."""
        return self._entry(axis)[0]

    def axis_index(self, axis):
        """This rank's coordinate along `axis`."""
        self._entry(axis)
        return self.coords[axis]

    def axis_size(self, axis):
        return self.shape.get(axis, 1)


class _Group:
    """A group handle (Paddle's ring_id): bound to a mesh axis of the
    current mesh, or to explicit world ranks with their own process
    group."""

    def __init__(self, gid, axis_name, ranks=None, process_group=None):
        self.id = gid
        self.axis_name = axis_name
        self.ranks = ranks
        self._pg = process_group

    @property
    def process_group(self):
        if self.ranks:
            return self._pg
        m = get_mesh()
        return None if m is None else m.group(self.axis_name)

    @property
    def nranks(self):
        if self.ranks:
            return len(self.ranks)
        m = get_mesh()
        return int(m.shape[self.axis_name]) if m is not None else 1

    @property
    def rank(self):
        """This rank's index in the group."""
        if self.ranks:
            return self.ranks.index(_world()[1])
        m = get_mesh()
        return 0 if m is None else m.axis_index(self.axis_name)

    def __repr__(self):
        return f"_Group(id={self.id}, axis={self.axis_name!r})"


def default_mesh():
    """The 1-D data-parallel mesh over every rank (the DP allreduce ring
    analog)."""
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = Mesh({DP_AXIS: _world()[0]})
        _groups[0] = _Group(0, DP_AXIS)
    return _current_mesh


def make_mesh(shape_dict):
    """Build and install an N-D mesh, e.g. {'dp': 2, 'sp': 2}."""
    global _current_mesh
    _current_mesh = Mesh(shape_dict)
    _groups.clear()
    _groups[0] = _Group(0, _current_mesh.axis_names[0])
    return _current_mesh


def set_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh
    return mesh


def get_mesh():
    return _current_mesh


def mesh_axes():
    m = get_mesh()
    return tuple(m.axis_names) if m is not None else ()


def register_group(axis_name, ranks=None, process_group=None):
    """ring_id/new_group analog: a group handle bound to a mesh axis, or
    to explicit ranks and their process group."""
    global _next_group_id
    gid = _next_group_id
    _next_group_id += 1
    g = _Group(gid, axis_name, ranks, process_group)
    _groups[gid] = g
    return g


def get_group(group=None):
    if group is None or group == 0:
        default_mesh()
        return _groups[0]
    if isinstance(group, _Group):
        return group
    return _groups[int(group)]


def reset():
    """Forget the mesh and every group (the process group is left)."""
    global _current_mesh, _next_group_id
    _current_mesh = None
    _groups.clear()
    _next_group_id = 1


class MeshContext:
    """Install a mesh for a `with` block (`with MeshContext({'dp': 2}):`),
    putting the previous one back after."""

    def __init__(self, shape_dict_or_mesh):
        self.mesh = shape_dict_or_mesh if isinstance(
            shape_dict_or_mesh, Mesh) else Mesh(shape_dict_or_mesh)
        self._saved = None

    def __enter__(self):
        global _current_mesh
        self._saved = _current_mesh
        _current_mesh = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _current_mesh
        _current_mesh = self._saved
        return False
