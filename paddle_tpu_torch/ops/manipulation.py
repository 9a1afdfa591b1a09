"""Shape/index manipulation ops (the port of `paddle_tpu/ops/manipulation.py`;
ref operators/reshape_op.cc, transpose_op.cc, concat/split/slice/gather/
scatter, python/paddle/tensor/manipulation.py surface).

Index tensors may be int32 (the port's integer type); the ops that need
int64 indices in torch cast them inside. Indexing follows numpy: a
negative-step slice, which torch's slicing does not take, is a `flip`
and a positive-step slice. `nonzero` and `masked_select` have
data-dependent output shapes: they run on the tensor's device and
synchronise with the host to size their outputs.
"""
import builtins

import numpy as np
import torch

from ..framework.dtype import convert_dtype, dtype_name
from ..framework.tensor import Tensor, to_torch
from .dispatch import apply, as_array, register_op


def _axes(axis):
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _cast_raw(a, to_dtype="float32"):
    return a.to(convert_dtype(to_dtype))


register_op("cast", _cast_raw)


def cast(x, dtype):
    return apply(_cast_raw, (x,), {"to_dtype": dtype_name(
        convert_dtype(dtype))}, name="cast")


def reshape(x, shape, name=None):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    shape = tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                  for s in shape)
    return apply(_reshape_raw, (x,), {"shape": shape}, name="reshape")


def _reshape_raw(a, shape=()):
    return torch.reshape(a, tuple(shape))


register_op("reshape", _reshape_raw)


def reshape_(x, shape, name=None):
    x._data = reshape(x, shape)._data
    return x


def _flatten_raw(a, start_axis=0, stop_axis=-1):
    nd = a.dim()
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return torch.reshape(a, a.shape[:s] + (-1,) + a.shape[e + 1:])


register_op("flatten", _flatten_raw)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return apply(_flatten_raw, (x,),
                 {"start_axis": int(start_axis), "stop_axis": int(stop_axis)},
                 name="flatten")


def _transpose_raw(a, perm=()):
    return a.permute(tuple(perm))


register_op("transpose", _transpose_raw)


def transpose(x, perm, name=None):
    perm = tuple(int(p) for p in perm)
    return apply(_transpose_raw, (x,), {"perm": perm}, name="transpose")


def _moveaxis_raw(a, source=0, destination=0):
    src = tuple(source) if isinstance(source, list) else source
    dst = tuple(destination) if isinstance(destination, list) else destination
    return torch.movedim(a, src, dst)


register_op("moveaxis", _moveaxis_raw)


def moveaxis(x, source, destination, name=None):
    conv = (lambda v: [int(i) for i in v] if isinstance(v, (list, tuple))
            else int(v))
    return apply(_moveaxis_raw, (x,),
                 {"source": conv(source), "destination": conv(destination)},
                 name="moveaxis")


def _swapaxes_raw(a, axis1=0, axis2=1):
    return torch.swapaxes(a, axis1, axis2)


register_op("swapaxes", _swapaxes_raw)


def swapaxes(x, axis1, axis2, name=None):
    return apply(_swapaxes_raw, (x,),
                 {"axis1": int(axis1), "axis2": int(axis2)}, name="swapaxes")


def _t_raw(a):
    return a.permute(tuple(reversed(range(a.dim()))))


register_op("t", _t_raw)


def t(x, name=None):
    return apply(_t_raw, (x,), name="t")


def concat(x, axis=0, name=None):
    tensors = list(x)
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply(_concat_raw, tuple(tensors), {"axis": int(axis)},
                 name="concat")


def _concat_raw(*arrs, axis=0):
    return torch.cat(arrs, dim=axis)


register_op("concat", _concat_raw)


def _stack_raw(*arrs, axis=0):
    return torch.stack(arrs, dim=axis)


register_op("stack", _stack_raw)


def stack(x, axis=0, name=None):
    return apply(_stack_raw, tuple(x), {"axis": int(axis)}, name="stack")


def _unstack_raw(a, axis=0, num=1):
    return torch.unbind(a, dim=axis)


register_op("unstack", _unstack_raw)


def unstack(x, axis=0, num=None, name=None):
    n = num or x.shape[axis]
    return list(apply(_unstack_raw, (x,), {"axis": int(axis), "num": int(n)},
                      name="unstack"))


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    nos = num_or_sections
    if not isinstance(nos, int):
        nos = [int(s.item()) if isinstance(s, Tensor) else int(s) for s in nos]
    return list(apply(_split_raw, (x,), {"num_or_sections": nos,
                                         "axis": int(axis)}, name="split"))


def _split_raw(a, num_or_sections=1, axis=0):
    total = a.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: {total} along axis {axis} does not "
                             f"divide into {num_or_sections} equal parts")
        return torch.split(a, total // num_or_sections, dim=axis)
    secs = [int(s) for s in num_or_sections]
    known = builtins.sum(s for s in secs if s >= 0)
    secs = [s if s >= 0 else total - known for s in secs]
    return torch.split(a, secs, dim=axis)


register_op("split", _split_raw)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def _unbind_raw(a, axis=0):
    return torch.unbind(a, dim=axis)


register_op("unbind", _unbind_raw)


def unbind(x, axis=0, name=None):
    return list(apply(_unbind_raw, (x,), {"axis": int(axis)}, name="unbind"))


def _squeeze_raw(a, axis=None):
    if axis is None:
        return torch.squeeze(a)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = tuple(ax % a.dim() for ax in axes)
    axes = tuple(ax for ax in axes if a.shape[ax] == 1)
    return torch.squeeze(a, axes) if axes else a


register_op("squeeze", _squeeze_raw)


def squeeze(x, axis=None, name=None):
    if isinstance(axis, (list, tuple)):
        axis = [int(a) for a in axis]
    elif axis is not None:
        axis = int(axis)
    return apply(_squeeze_raw, (x,), {"axis": axis}, name="squeeze")


def _unsqueeze_raw(a, axis=0):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    out = a
    for ax in builtins.sorted(int(v) for v in axes):
        out = torch.unsqueeze(out, ax)
    return out


register_op("unsqueeze", _unsqueeze_raw)


def unsqueeze(x, axis, name=None):
    if isinstance(axis, (list, tuple)):
        axis = [int(a) for a in axis]
    else:
        axis = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    return apply(_unsqueeze_raw, (x,), {"axis": axis}, name="unsqueeze")


def expand(x, shape, name=None):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    shape = [int(s) for s in shape]
    return apply(_expand_raw, (x,), {"shape": shape}, name="expand")


def _expand_raw(a, shape=()):
    tgt = list(shape)
    src_shape = (1,) * (len(tgt) - a.dim()) + tuple(a.shape)
    tgt = [src_shape[i] if tgt[i] == -1 else tgt[i] for i in range(len(tgt))]
    return a.reshape(src_shape).expand(tgt)


register_op("expand", _expand_raw)


broadcast_to = expand


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def tile(x, repeat_times, name=None):
    if isinstance(repeat_times, Tensor):
        repeat_times = repeat_times.tolist()
    reps = tuple(int(r) for r in repeat_times)
    return apply(_tile_raw, (x,), {"reps": reps}, name="tile")


def _tile_raw(a, reps=()):
    return torch.tile(a, tuple(reps))


register_op("tile", _tile_raw)


def _repeat_interleave_raw(a, repeats=1, axis=None):
    if isinstance(repeats, (list, tuple)):
        repeats = torch.tensor(repeats, device=a.device)
    if axis is None:
        return torch.repeat_interleave(a.reshape(-1), repeats)
    return torch.repeat_interleave(a, repeats, dim=axis)


def _flip_raw(a, axis=0):
    ax = _axes(axis)
    return torch.flip(a, ax if isinstance(ax, tuple) else (ax,))


def _roll_raw(a, shifts=0, axis=None):
    sh = tuple(shifts) if isinstance(shifts, list) else shifts
    ax = tuple(axis) if isinstance(axis, list) else axis
    if ax is None:
        return torch.roll(a, sh)
    return torch.roll(a, sh, ax)


def _rot90_raw(a, k=1, axes=(0, 1)):
    return torch.rot90(a, k, tuple(axes))


register_op("repeat_interleave", _repeat_interleave_raw)
register_op("flip", _flip_raw)
register_op("roll", _roll_raw)
register_op("rot90", _rot90_raw)


def repeat_interleave(x, repeats, axis=None, name=None):
    r = repeats.tolist() if isinstance(repeats, Tensor) else repeats
    r = [int(v) for v in r] if isinstance(r, (list, tuple)) else int(r)
    return apply(_repeat_interleave_raw, (x,),
                 {"repeats": r, "axis": None if axis is None else int(axis)},
                 name="repeat_interleave")


def flip(x, axis, name=None):
    ax = [int(a) for a in axis] if isinstance(axis, (list, tuple)) \
        else int(axis)
    return apply(_flip_raw, (x,), {"axis": ax}, name="flip")


def roll(x, shifts, axis=None, name=None):
    conv = (lambda v: [int(i) for i in v] if isinstance(v, (list, tuple))
            else (None if v is None else int(v)))
    return apply(_roll_raw, (x,), {"shifts": conv(shifts), "axis": conv(axis)},
                 name="roll")


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply(_rot90_raw, (x,),
                 {"k": int(k), "axes": [int(a) for a in axes]}, name="rot90")


# ----------------------------------------------------------------- index ops

def _consumes(i):
    """How many input dims an index item addresses."""
    if i is None:
        return 0
    if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
        return builtins.max(i.dim(), 1)
    return 1


def _expand_ellipsis(items, nd):
    """[(input dim, item)] with Ellipsis replaced by full slices (None
    items get the dim they precede, and address none)."""
    used = builtins.sum(_consumes(i) for i in items if i is not Ellipsis)
    out, dim = [], 0
    for i in items:
        if i is Ellipsis:
            for _ in range(nd - used):
                out.append((dim, builtins.slice(None)))
                dim += 1
            continue
        out.append((dim, i))
        dim += _consumes(i)
    return out


def _index(a, idx):
    """a[idx] with numpy semantics: negative-step slices become a flip of
    their dim and a positive-step slice; int32 index tensors are long."""
    items = list(idx) if isinstance(idx, tuple) else [idx]
    if not any(i is Ellipsis for i in items) and not any(
            isinstance(i, builtins.slice) and i.step is not None
            and i.step < 0 for i in items):
        return a[idx if isinstance(idx, tuple) else idx]
    out, flips = [], []
    for dim, i in _expand_ellipsis(items, a.dim()):
        if isinstance(i, builtins.slice) and i.step is not None and i.step < 0:
            n = a.shape[dim]
            start, stop, step = i.indices(n)
            flips.append(dim)
            i = builtins.slice(n - 1 - start, n - 1 - stop, -step)
        out.append(i)
    if flips:
        a = torch.flip(a, flips)
    return a[tuple(out)]


def _index_spec(idx):
    """JSON-able encoding of a BASIC index (ints/slices/None/Ellipsis,
    tuples thereof) or None when the index needs arrays."""
    def enc(i):
        if isinstance(i, bool):
            return None
        if isinstance(i, (int, np.integer)):
            return ["i", int(i)]
        if isinstance(i, builtins.slice):
            def v(x):
                return None if x is None else int(x)
            return ["s", v(i.start), v(i.stop), v(i.step)]
        if i is None:
            return ["n"]
        if i is Ellipsis:
            return ["e"]
        return None

    items = idx if isinstance(idx, tuple) else (idx,)
    out = []
    for i in items:
        e = enc(i)
        if e is None:
            return None
        out.append(e)
    return out


def _getitem_raw(a, spec=()):
    idx = []
    for e in spec:
        if e[0] == "i":
            idx.append(int(e[1]))
        elif e[0] == "s":
            idx.append(builtins.slice(e[1], e[2], e[3]))
        elif e[0] == "n":
            idx.append(None)
        else:
            idx.append(Ellipsis)
    return _index(a, tuple(idx))


register_op("getitem", _getitem_raw)


def getitem(x, idx):
    spec = _index_spec(idx)
    if spec is not None:
        return apply(_getitem_raw, (x,), {"spec": spec}, name="getitem")
    t_idx = _torch_index(idx, as_array(x).device)
    return apply(lambda a: _index(a, t_idx), (x,), name="getitem")


def _torch_index(idx, device):
    """A Paddle index made torch's: Tensors, lists and arrays as index
    tensors on `device` (integer ones int64), and an integer beside an
    index tensor as an advanced index, as numpy reads it (which decides
    where the indexed dims go; torch reads it as basic): a [1] index
    tensor (a 0-d one torch reads as an integer), which broadcasts
    against the others as numpy's does."""
    def conv(i):
        if isinstance(i, Tensor):
            i = i._data
        elif isinstance(i, (list, np.ndarray)):
            i = to_torch(np.asarray(i), place=device)
        if isinstance(i, torch.Tensor) and i.dtype not in (torch.bool,
                                                           torch.uint8):
            return i.long()
        if isinstance(i, tuple):
            return tuple(conv(j) for j in i)
        return i
    idx = conv(idx)
    if not isinstance(idx, tuple) or not builtins.any(
            isinstance(i, torch.Tensor) and i.dim() for i in idx):
        return idx
    return tuple(torch.full((1,), int(i), dtype=torch.long, device=device)
                 if isinstance(i, (int, np.integer))
                 and not isinstance(i, bool) else i for i in idx)


def _neg_steps_as_indices(idx, shape):
    """`idx` with every negative-step slice an index tensor: a write
    cannot go through `_index`'s flip."""
    items = list(idx) if isinstance(idx, tuple) else [idx]
    if not builtins.any(isinstance(i, builtins.slice) and i.step is not None
                        and i.step < 0 for i in items):
        return idx
    out = []
    for dim, i in _expand_ellipsis(items, len(shape)):
        if isinstance(i, builtins.slice) and i.step is not None \
                and i.step < 0:
            i = torch.arange(*i.indices(shape[dim]))
        out.append(i)
    return tuple(out)


def _slice_raw(a, axes=(), starts=(), ends=()):
    idx = [builtins.slice(None)] * a.dim()
    for ax, s, e in zip(axes, starts, ends):
        idx[int(ax)] = builtins.slice(int(s), int(e))
    return a[tuple(idx)]


register_op("slice", _slice_raw)


def slice(x, axes, starts, ends, name=None):
    starts = [int(s.item()) if isinstance(s, Tensor) else int(s)
              for s in starts]
    ends = [int(e.item()) if isinstance(e, Tensor) else int(e) for e in ends]
    return apply(_slice_raw, (x,),
                 {"axes": [int(a) for a in axes], "starts": starts,
                  "ends": ends}, name="slice")


def _strided_slice_raw(a, axes=(), starts=(), ends=(), strides=()):
    idx = [builtins.slice(None)] * a.dim()
    for ax, s, e, st in zip(axes, starts, ends, strides):
        idx[int(ax)] = builtins.slice(int(s), int(e), int(st))
    return _index(a, tuple(idx))


register_op("strided_slice", _strided_slice_raw)


def strided_slice(x, axes, starts, ends, strides, name=None):
    def conv(v):
        return [int(i.item()) if isinstance(i, Tensor) else int(i)
                for i in v]
    return apply(_strided_slice_raw, (x,),
                 {"axes": conv(axes), "starts": conv(starts),
                  "ends": conv(ends), "strides": conv(strides)},
                 name="strided_slice")


def gather(x, index, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply(_gather_raw, (x, index), {"axis": int(axis)}, name="gather")


def _take_axis(a, idx, axis):
    """jnp.take(a, idx, axis): idx's shape replaces dim `axis`."""
    axis = axis % a.dim()
    flat = torch.index_select(a, axis, idx.reshape(-1).long())
    return flat.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def _gather_raw(a, idx, axis=0):
    return _take_axis(a, idx.reshape(-1) if idx.dim() > 1 else idx, axis)


register_op("gather", _gather_raw)


def _take_along_axis_raw(a, i, axis=0):
    return torch.take_along_dim(a, i.long(), dim=axis)


register_op("take_along_axis", _take_along_axis_raw)


def take_along_axis(x, indices, axis, name=None):
    return apply(_take_along_axis_raw, (x, indices), {"axis": int(axis)},
                 name="take_along_axis")


def _put_along_axis_raw(a, i, v, axis=0, reduce="assign"):
    if not isinstance(v, torch.Tensor):
        v = torch.full((), v, device=a.device)
    v = torch.broadcast_to(v, i.shape).to(a.dtype)
    i = i.long()
    if reduce == "assign":
        return torch.scatter(a, axis, i, v)
    if reduce == "add":
        return torch.scatter_add(a, axis, i, v)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(a, axis, i, v, "prod")
    raise ValueError(reduce)


register_op("put_along_axis", _put_along_axis_raw)


def put_along_axis(x, indices, values, axis, reduce="assign", name=None):
    return apply(_put_along_axis_raw, (x, indices, values),
                 {"axis": int(axis), "reduce": str(reduce)},
                 name="put_along_axis")


def _comps(idx):
    return tuple(idx[..., i].long() for i in range(idx.shape[-1]))


def _gather_nd_raw(a, idx):
    return a[_comps(idx)]


def _scatter_raw(a, idx, upd, overwrite=True):
    idx = idx.reshape(-1).long()
    upd = upd.to(a.dtype)
    if overwrite:
        return torch.index_put(a, (idx,), upd)
    # paddle scatter(overwrite=False) zeroes target rows then adds
    zeroed = torch.index_put(a, (idx,), torch.zeros_like(upd))
    return torch.index_put(zeroed, (idx,), upd, accumulate=True)


def _scatter_nd_add_raw(a, idx, upd):
    return torch.index_put(a, _comps(idx), upd.to(a.dtype), accumulate=True)


register_op("gather_nd", _gather_nd_raw)
register_op("scatter", _scatter_raw)
register_op("scatter_nd_add", _scatter_nd_add_raw)


def gather_nd(x, index, name=None):
    return apply(_gather_nd_raw, (x, index), name="gather_nd")


def scatter(x, index, updates, overwrite=True, name=None):
    return apply(_scatter_raw, (x, index, updates),
                 {"overwrite": bool(overwrite)}, name="scatter")


def scatter_nd_add(x, index, updates, name=None):
    return apply(_scatter_nd_add_raw, (x, index, updates),
                 name="scatter_nd_add")


def scatter_nd(index, updates, shape, name=None):
    idx, upd = to_torch(index), to_torch(updates)
    zeros = torch.zeros(tuple(shape), dtype=upd.dtype, device=upd.device)
    return Tensor._wrap(torch.index_put(zeros, _comps(idx), upd,
                                        accumulate=True))


def _index_select_raw(a, i, axis=0):
    return _take_axis(a, i, axis)


def _index_sample_raw(a, i):
    return torch.take_along_dim(a, i.long(), dim=1)


def _where_raw(c, a, b):
    return torch.where(c, a, b)


register_op("index_select", _index_select_raw)
register_op("index_sample", _index_sample_raw)
register_op("where", _where_raw)


def index_select(x, index, axis=0, name=None):
    return apply(_index_select_raw, (x, index), {"axis": int(axis)},
                 name="index_select")


def index_sample(x, index, name=None):
    return apply(_index_sample_raw, (x, index), name="index_sample")


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return apply(_where_raw, (condition, x, y), name="where")


def nonzero(x, as_tuple=False):
    """Indices of the nonzero elements, [N, ndim] int32 (or a tuple of
    [N, 1]); computed on the device, sized through one sync."""
    nz = torch.nonzero(to_torch(x)).to(torch.int32)
    if as_tuple:
        return tuple(Tensor._wrap(nz[:, i:i + 1].contiguous())
                     for i in range(nz.shape[1]))
    return Tensor._wrap(nz)


def masked_select(x, mask, name=None):
    """The elements of `x` where `mask` holds, 1-D; on the device, sized
    through one sync."""
    a, m = to_torch(x), to_torch(mask)
    return Tensor._wrap(a[m.bool()])


def _masked_fill_raw(a, m, value=0.0):
    return torch.where(m, torch.full((), value, dtype=a.dtype,
                                     device=a.device), a)


register_op("masked_fill", _masked_fill_raw)


def masked_fill(x, mask, value, name=None):
    v = value.item() if isinstance(value, Tensor) else value
    return apply(_masked_fill_raw, (x, mask), {"value": float(v)},
                 name="masked_fill")


def _fill_diagonal_raw(a, value=0.0, offset=0):
    if a.dim() != 2:
        raise ValueError(
            f"fill_diagonal: only 2-D tensors supported, got ndim={a.dim()}")
    eye = torch.ones(a.shape, dtype=torch.bool, device=a.device).triu(
        offset).tril(offset)
    return torch.where(eye, torch.full((), value, dtype=a.dtype,
                                       device=a.device), a)


register_op("fill_diagonal", _fill_diagonal_raw)


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    if wrap:
        raise NotImplementedError(
            "fill_diagonal: wrap=True (tall-matrix diagonal wrapping) is "
            "not supported")
    return apply(_fill_diagonal_raw, (x,),
                 {"value": float(value), "offset": int(offset)},
                 name="fill_diagonal")


def _shard_index_raw(idx, index_num=1, nshards=1, shard_id=0, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    hi = lo + shard_size
    in_shard = (idx >= lo) & (idx < hi)
    return torch.where(in_shard, idx - lo, torch.full(
        (), ignore_value, dtype=idx.dtype, device=idx.device))


register_op("shard_index", _shard_index_raw)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """TP helper (ref operators/shard_index_op.cc): map global ids to
    shard-local, ignore_value for out-of-shard."""
    return apply(_shard_index_raw, (input,),
                 {"index_num": int(index_num), "nshards": int(nshards),
                  "shard_id": int(shard_id), "ignore_value": int(ignore_value)},
                 differentiable=False, name="shard_index")


def _one_hot_raw(i, num_classes=1):
    # an out-of-range id gives a zero row, as jax.nn.one_hot does
    classes = torch.arange(num_classes, device=i.device)
    return (i[..., None] == classes).to(torch.float32)


register_op("one_hot", _one_hot_raw)


def one_hot(x, num_classes, name=None):
    return apply(_one_hot_raw, (x,), {"num_classes": int(num_classes)},
                 differentiable=False, name="one_hot")


def _tensordot_raw(a, b, axes=2):
    if isinstance(axes, list) and axes and isinstance(axes[0],
                                                     (list, tuple)):
        axes = [list(v) for v in axes]
    elif isinstance(axes, list):
        axes = [[axes[0]], [axes[1]]]
    return torch.tensordot(a, b, dims=axes)


register_op("tensordot", _tensordot_raw)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = [list(int(i) for i in v) if isinstance(v, (list, tuple))
                else int(v) for v in axes]
    else:
        axes = int(axes)
    return apply(_tensordot_raw, (x, y), {"axes": axes}, name="tensordot")


def _as_complex_raw(a):
    return torch.complex(a[..., 0], a[..., 1])


def _as_real_raw(a):
    return torch.stack([torch.real(a), torch.imag(a)], dim=-1)


register_op("as_complex", _as_complex_raw)
register_op("as_real", _as_real_raw)


def as_complex(x, name=None):
    return apply(_as_complex_raw, (x,), name="as_complex")


def as_real(x, name=None):
    return apply(_as_real_raw, (x,), name="as_real")


def _crop_raw(a, shape=(), offsets=None):
    offs = offsets or [0] * a.dim()
    out = a
    for d, (o, s) in enumerate(zip(offs, shape)):
        n = a.shape[d]
        s = n - o if s == -1 else s
        # lax.dynamic_slice clamps the start so the window fits
        o = builtins.min(builtins.max(int(o), 0), n - s)
        out = out.narrow(d, o, s)
    return out


register_op("crop", _crop_raw)


def crop(x, shape=None, offsets=None, name=None):
    return apply(_crop_raw, (x,),
                 {"shape": [int(s) for s in shape],
                  "offsets": None if offsets is None
                  else [int(o) for o in offsets]}, name="crop")


# --------------------------------------------------------------- round-3 tail

def _take_raw(a, idx, mode="raise"):
    flat = a.reshape(-1)
    n = flat.shape[0]
    idx = idx.long()
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    else:
        idx = torch.where(idx < 0, idx + n, idx)
    return flat[idx]


def _index_add_raw(a, index, value, axis=0):
    return torch.index_add(a, axis, index.long(), value.to(a.dtype))


def _index_put_raw(a, index, value, accumulate=False):
    return torch.index_put(a, _comps(index), value.to(a.dtype),
                           accumulate=accumulate)


def _masked_scatter_raw(a, mask, value):
    # value's first elements fill True positions in row-major order (ref
    # masked_scatter_op): scatter value[cumsum(mask)-1] where mask
    flatm = mask.reshape(-1)
    src_idx = torch.clamp(torch.cumsum(flatm.long(), 0) - 1, 0,
                          value.numel() - 1)
    vals = value.reshape(-1)[src_idx]
    return torch.where(flatm, vals, a.reshape(-1)).reshape(a.shape)


def _unflatten_raw(a, axis=0, shape=()):
    ax = axis % a.dim()
    shape = tuple(shape)
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape = tuple(a.shape[ax] // known if s == -1 else s for s in shape)
    return a.reshape(a.shape[:ax] + shape + a.shape[ax + 1:])


register_op("take", _take_raw)
register_op("index_add", _index_add_raw)
register_op("index_put", _index_put_raw)
register_op("masked_scatter", _masked_scatter_raw)
register_op("unflatten", _unflatten_raw)


def take(x, index, mode="raise", name=None):
    return apply(_take_raw, (x, index), {"mode": str(mode)}, name="take")


def index_add(x, index, axis, value, name=None):
    return apply(_index_add_raw, (x, index, value), {"axis": int(axis)},
                 name="index_add")


def index_put(x, indices, value, accumulate=False, name=None):
    idx = indices
    if isinstance(idx, (list, tuple)):
        arrs = [to_torch(i) for i in idx]
        if any(a.dtype == torch.bool for a in arrs):
            raise NotImplementedError(
                "index_put: boolean-mask indices are not supported "
                "(dynamic shapes); use masked_fill/masked_scatter")
        # paddle broadcasts the index tensors against each other
        idx = Tensor._wrap(torch.stack(torch.broadcast_tensors(*arrs),
                                       dim=-1))
    return apply(_index_put_raw, (x, idx, value),
                 {"accumulate": bool(accumulate)}, name="index_put")


def masked_scatter(x, mask, value, name=None):
    return apply(_masked_scatter_raw, (x, mask, value),
                 name="masked_scatter")


def unflatten(x, axis, shape, name=None):
    return apply(_unflatten_raw, (x,),
                 {"axis": int(axis), "shape": [int(s) for s in shape]},
                 name="unflatten")
