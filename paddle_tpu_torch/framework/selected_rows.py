"""SelectedRows — row-sparse gradients for embedding tables (the port of
`paddle_tpu/framework/selected_rows.py`; ref
paddle/fluid/framework/selected_rows.h + operators/sum_op sparse
accumulation).

A SelectedRows holds (rows, values[len(rows), dim], height): the gradient
of an embedding lookup touches only the looked-up rows. rows and values
are torch tensors on one device; nothing here reads them back to the
host. `F.embedding(sparse=True)` on a trainable leaf table makes the
table's gradient a torch sparse COO tensor; the table's `.grad` presents
it as a SelectedRows (`from_sparse`), and the optimizers update the rows
it names (`lazy_mode`).
"""
import torch


def _tensor(x, dtype=None, device=None):
    from .tensor import Tensor
    if isinstance(x, Tensor):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype) if (
            device is not None or dtype is not None) else x
    return torch.as_tensor(x, dtype=dtype, device=device)


class SelectedRows:
    def __init__(self, rows, values, height):
        self.values = _tensor(values)
        self.rows = _tensor(rows, torch.int32,
                            self.values.device).reshape(-1)
        self.height = int(height)
        if self.values.shape[0] != self.rows.shape[0]:
            raise ValueError(f"SelectedRows: {self.values.shape[0]} value "
                             f"rows for {self.rows.shape[0]} row ids")

    @property
    def shape(self):
        return [self.height] + list(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def merge(self):
        """Deduplicate rows, summing their values (ref
        operators/math/selected_rows_functor.cc MergeAdd); rows come back
        sorted."""
        uniq, inv = torch.unique(self.rows, sorted=True, return_inverse=True)
        summed = torch.zeros((uniq.shape[0],) + tuple(self.values.shape[1:]),
                             dtype=self.values.dtype,
                             device=self.values.device)
        summed.index_add_(0, inv, self.values)
        return SelectedRows(uniq, summed, self.height)

    def to_dense(self):
        out = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                          dtype=self.values.dtype, device=self.values.device)
        return out.index_add_(0, self.rows.long(), self.values)

    def astype(self, dtype):
        from .dtype import convert_dtype
        return SelectedRows(self.rows, self.values.to(convert_dtype(dtype)),
                            self.height)

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.height != self.height:
                raise ValueError(f"SelectedRows heights differ: "
                                 f"{self.height} and {other.height}")
            return SelectedRows(
                torch.cat([self.rows, other.rows]),
                torch.cat([self.values,
                           other.values.to(self.values.dtype)]),
                self.height)
        # dense + sparse -> dense
        return self.to_dense() + _tensor(other)

    __radd__ = __add__

    @classmethod
    def from_sparse(cls, g):
        """A torch sparse COO gradient [height, ...] as a SelectedRows
        (its rows as they are, duplicates included)."""
        return cls(g._indices()[0], g._values(), g.shape[0])

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]}, "
                f"dim={tuple(self.values.shape[1:])})")
