"""Sparse tensors with named dims — port of `phiflow_tpu/math/_sparse.py`.

`SparseCooTensor` (indices over named sparse dims, values per entry),
`SparseCompressedTensor` (csr / csc of a (row, ~column) matrix) and
`CompactSparseTensor` (a fixed number of slots per row, −1 in the unused
ones), the functions `sparse_tensor`, `is_sparse`, `dense`, `to_format`,
`stored_indices`, `stored_values` and `matrix_from_function`.

Each format densifies by `index_put_` with accumulation and multiplies a
dense Tensor (its dual dim contracted with the primal dim of that name) by
gathering the columns' entries and summing the products by row with
`index_add_`, as JAX sums its segments: PyTorch operations on the values'
device, as JAX's are XLA. Elementwise operations with a number act on the
stored values; with a Tensor on the dense form. The stored arrays live on the
default device (host-constant indices and values move there).

`matrix_from_function` takes the exact coefficients of the Jacobian (JAX:
`jax.jacfwd`) by reverse-mode autograd on the flat input vector, then keeps
the nonzeros.
"""
from __future__ import annotations

import numpy as np
import torch

from ._shape import DUAL, Dim, Shape, channel, dual, instance
from ._tensor import Tensor, to_torch, wrap

__all__ = ['SparseCooTensor', 'SparseCompressedTensor', 'CompactSparseTensor', 'sparse_tensor', 'is_sparse', 'dense',
           'to_format', 'stored_indices', 'stored_values', 'matrix_from_function']


def _flat_index(coords: torch.Tensor, sizes) -> torch.Tensor:
    """Row-major flat index of (entries, rank) integer coordinates."""
    flat = torch.zeros(coords.shape[0], dtype=torch.int64, device=coords.device)
    for axis, n in enumerate(sizes):
        flat = flat * int(n) + coords[:, axis].to(torch.int64)
    return flat


def _matmul(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, row_shape: Shape, dual_dims: Shape,
            other: Tensor) -> Tensor:
    """Σ_col vals · other[col] by row: `rows` / `cols` flat indices of the entries into `row_shape` and
    `dual_dims`, whose primal names `other` carries; `other`'s remaining dims are kept."""
    primal = [n[1:] for n in dual_dims.names]
    rest = other.shape.without(primal)
    x = other.torch(tuple(primal) + rest.names)
    x = x.reshape((-1,) + tuple(x.shape[len(primal):]))
    contrib = x.index_select(0, cols).to(vals.dtype) * vals.reshape((-1,) + (1,) * rest.rank)
    out = torch.zeros((max(row_shape.volume, 1),) + tuple(rest.sizes), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, rows, contrib)
    return Tensor(out.reshape(tuple(row_shape.sizes) + tuple(rest.sizes)), row_shape & rest)


class SparseCooTensor(Tensor):
    """COO sparse tensor: `indices` (instance 'entries', channel 'sparse_idx'
    labelled with the sparse dims' names), `values` (entries,) and the full
    `dense_shape`."""

    def __init__(self, indices: Tensor, values: Tensor, dense_shape: Shape):
        self._indices = indices
        self._values = values
        self._dense_shape = dense_shape

    @property
    def shape(self) -> Shape:
        return self._dense_shape

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def is_host(self) -> bool:
        return False

    @property
    def device(self):
        return self._values.torch().device

    @property
    def sparse_dims(self) -> Shape:
        labels = self._indices.shape.get_labels('sparse_idx')
        return self._dense_shape.only(list(labels), reorder=True)

    @property
    def entries(self) -> int:
        return self._indices.shape.get_size('entries')

    def _coords(self) -> torch.Tensor:
        """(entries, sparse dims) int64 coordinates in `sparse_dims` order, on the values' device."""
        return self._indices.torch(('entries', 'sparse_idx'), self.device).to(self.device, torch.int64)

    def _dense(self) -> Tensor:
        """The dense form, its dims in `dense_shape`'s order (as JAX's scatter gives them)."""
        sd = self.sparse_dims
        order = [sd.index(n) for n in self._dense_shape.names]
        vals = self._values.torch()
        arr = torch.zeros(tuple(self._dense_shape.sizes), dtype=vals.dtype, device=vals.device)
        arr.index_put_(tuple(self._coords().T[order]), vals, accumulate=True)
        return Tensor(arr, self._dense_shape)

    def native(self, order=None):
        return self._dense().native(order)

    def numpy(self, order=None):
        return self._dense().numpy(order)

    def torch(self, order=None, device=None):
        return self._dense().torch(order, device)

    def _op1(self, fn):
        return SparseCooTensor(self._indices, self._values._op1(fn), self._dense_shape)

    def _op2(self, other, fn, reverse=False):
        if isinstance(other, (int, float)):
            return SparseCooTensor(self._indices, self._values._op2(other, fn, reverse), self._dense_shape)
        return self._dense()._op2(other, fn, reverse)

    def __getitem__(self, item):
        return self._dense()[item]

    def __matmul__(self, other: Tensor) -> Tensor:
        """The product with a dense Tensor: self's dual dims contracted with
        other's primal dims of the same names."""
        sd = self.sparse_dims
        duals, rows = sd.dual, sd.without(sd.dual.names)
        coords = self._coords()
        row_idx = _flat_index(coords[:, [sd.index(n) for n in rows.names]], rows.sizes)
        col_idx = _flat_index(coords[:, [sd.index(n) for n in duals.names]], duals.sizes)
        return _matmul(row_idx, col_idx, self._values.torch(), rows, duals, other)

    def __repr__(self):
        return f"SparseCoo[{self._dense_shape}, {self.entries} entries]"


class SparseCompressedTensor(Tensor):
    """A csr / csc sparse matrix over two named dims: `pointers`
    (n_compressed + 1,), `indices` (nnz,) along the other dim, `values`
    (nnz,). 'csr' compresses the row (primal) dim, 'csc' the column (dual)
    dim."""

    def __init__(self, pointers, indices, values, dense_shape: Shape, format: str, compressed_dim: str,
                 uncompressed_dim: str):
        assert format in ('csr', 'csc')
        self._pointers = to_torch(pointers)
        self._idx = to_torch(indices)
        self._vals = to_torch(values)
        self._dense_shape = dense_shape
        self._format = format
        self._compressed = compressed_dim
        self._uncompressed = uncompressed_dim

    @property
    def shape(self) -> Shape:
        return self._dense_shape

    @property
    def dtype(self):
        return self._vals.dtype

    @property
    def is_host(self) -> bool:
        return False

    @property
    def device(self):
        return self._vals.device

    @property
    def format(self) -> str:
        return self._format

    @property
    def entries(self) -> int:
        return int(self._idx.shape[0])

    def _entry_coords(self):
        """(compressed, uncompressed) int64 ids of every stored entry."""
        nnz = self._idx.shape[0]
        comp = torch.searchsorted(self._pointers.to(torch.int64), torch.arange(nnz, device=self._idx.device),
                                  right=True) - 1
        return comp, self._idx.to(torch.int64)

    def _dense(self) -> Tensor:
        comp, unc = self._entry_coords()
        n_comp, n_unc = self._dense_shape.get_size(self._compressed), self._dense_shape.get_size(self._uncompressed)
        arr = torch.zeros((n_comp, n_unc), dtype=self._vals.dtype, device=self._vals.device)
        arr.index_put_((comp, unc), self._vals, accumulate=True)
        return Tensor(arr, self._dense_shape.only([self._compressed, self._uncompressed], reorder=True))

    def native(self, order=None):
        return self._dense().native(order)

    def numpy(self, order=None):
        return self._dense().numpy(order)

    def torch(self, order=None, device=None):
        return self._dense().torch(order, device)

    def _with_values(self, values):
        return SparseCompressedTensor(self._pointers, self._idx, values, self._dense_shape, self._format,
                                      self._compressed, self._uncompressed)

    def _op1(self, fn):
        return self._with_values(fn(self._vals))

    def _op2(self, other, fn, reverse=False):
        if isinstance(other, (int, float)):
            return self._with_values(fn(other, self._vals) if reverse else fn(self._vals, other))
        return self._dense()._op2(other, fn, reverse)

    def __matmul__(self, other: Tensor) -> Tensor:
        dual_name = self._dense_shape.dual.name
        row_name = self._dense_shape.without(dual_name).name
        comp, unc = self._entry_coords()
        rows, cols = (comp, unc) if self._compressed == row_name else (unc, comp)
        return _matmul(rows, cols, self._vals, self._dense_shape.only(row_name), self._dense_shape.only(dual_name),
                       other)

    def __repr__(self):
        return f"Sparse{self._format.upper()}[{self._dense_shape}, {self.entries} entries]"


class CompactSparseTensor(Tensor):
    """A fixed number of slots per row: column indices and values as dense
    (rows, ~capacity) Tensors, −1 marking an unused slot."""

    def __init__(self, col_indices: Tensor, values: Tensor, dense_shape: Shape):
        self._cols = col_indices
        self._values = values
        self._dense_shape = dense_shape

    @property
    def shape(self) -> Shape:
        return self._dense_shape

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def is_host(self) -> bool:
        return False

    @property
    def device(self):
        return self._values.torch().device

    @property
    def capacity(self) -> int:
        return self._cols.shape.sizes[-1] if self._cols.shape.rank else 0

    def _slots(self):
        """(rows, slot) int64 column ids (−1 unused), values, and the row and dual dim names."""
        dual_name = self._dense_shape.dual.name
        row_name = self._dense_shape.without(dual_name).name
        cap_dim = [n for n in self._cols.shape.names if n != row_name][0]
        cols = self._cols.torch((row_name, cap_dim)).to(torch.int64)
        vals = self._values.torch((row_name, cap_dim))
        return cols, vals, row_name, dual_name

    def _dense(self) -> Tensor:
        cols, vals, row_name, dual_name = self._slots()
        valid = cols >= 0
        rows = torch.arange(cols.shape[0], device=cols.device).unsqueeze(1).expand_as(cols)
        arr = torch.zeros((cols.shape[0], self._dense_shape.get_size(dual_name)), dtype=vals.dtype, device=vals.device)
        arr.index_put_((rows[valid], cols[valid]), vals[valid], accumulate=True)
        return Tensor(arr, self._dense_shape.only([row_name, dual_name], reorder=True))

    def native(self, order=None):
        return self._dense().native(order)

    def numpy(self, order=None):
        return self._dense().numpy(order)

    def torch(self, order=None, device=None):
        return self._dense().torch(order, device)

    def _op1(self, fn):
        return CompactSparseTensor(self._cols, self._values._op1(fn), self._dense_shape)

    def _op2(self, other, fn, reverse=False):
        if isinstance(other, (int, float)):
            return CompactSparseTensor(self._cols, self._values._op2(other, fn, reverse), self._dense_shape)
        return self._dense()._op2(other, fn, reverse)

    def __matmul__(self, other: Tensor) -> Tensor:
        cols, vals, row_name, dual_name = self._slots()
        valid = (cols >= 0).reshape(-1)
        rows = torch.arange(cols.shape[0], device=cols.device).unsqueeze(1).expand_as(cols).reshape(-1)
        return _matmul(rows[valid], cols.reshape(-1)[valid], vals.reshape(-1)[valid],
                       self._dense_shape.only(row_name), self._dense_shape.only(dual_name), other)

    def __repr__(self):
        return f"CompactSparse[{self._dense_shape}, capacity {self.capacity}]"


def sparse_tensor(indices: Tensor, values: Tensor, dense_shape: Shape, can_contain_double_entries=True,
                  indices_sorted=False, format='coo', default=0) -> Tensor:
    """A sparse tensor from its indices and values (phiml's `sparse_tensor`)."""
    coo = SparseCooTensor(indices, values, dense_shape)
    if format == 'dense':
        return coo._dense()
    if format in ('csr', 'csc', 'compact'):
        return to_format(coo, format)
    return coo


def is_sparse(x) -> bool:
    return isinstance(x, (SparseCooTensor, SparseCompressedTensor, CompactSparseTensor))


def dense(x: Tensor) -> Tensor:
    return x._dense() if is_sparse(x) else x


def _coo_of(x: Tensor) -> SparseCooTensor:
    if isinstance(x, SparseCooTensor):
        return x
    d = dense(x)
    arr = d.torch(x.shape.names)
    nz = torch.nonzero(arr)
    idx = Tensor(nz.to(torch.int32), instance(entries=nz.shape[0]) & channel(sparse_idx=x.shape.names))
    return SparseCooTensor(idx, Tensor(arr[tuple(nz.T)], instance(entries=nz.shape[0])), x.shape)


def to_format(x: Tensor, format: str) -> Tensor:
    """Convert between the 'dense', 'coo', 'csr', 'csc' and 'compact'
    formats (phiml's `to_format`)."""
    if format == 'dense':
        return dense(x)
    coo = _coo_of(x)
    if format == 'coo':
        return coo
    labels = coo._indices.shape.get_labels('sparse_idx')
    dual_names = [n for n in labels if n.startswith('~')]
    row_names = [n for n in labels if not n.startswith('~')]
    assert len(dual_names) == 1 and len(row_names) == 1, \
        f"{format} requires a (row, ~col) matrix, got sparse dims {labels}"
    row_name, dual_name = row_names[0], dual_names[0]
    idx = coo._coords()
    vals = coo._values.torch()
    rows, cols = idx[:, labels.index(row_name)], idx[:, labels.index(dual_name)]
    n_rows = coo._dense_shape.get_size(row_name)
    if format in ('csr', 'csc'):
        comp, unc, n_comp = (rows, cols, n_rows) if format == 'csr' else \
            (cols, rows, coo._dense_shape.get_size(dual_name))
        order = torch.sort(comp, stable=True).indices
        pointers = torch.zeros(n_comp + 1, dtype=torch.int64, device=comp.device)
        pointers.index_add_(0, comp + 1, torch.ones_like(comp))
        return SparseCompressedTensor(torch.cumsum(pointers, 0).to(torch.int32), unc[order].to(torch.int32),
                                      vals[order], coo._dense_shape, format,
                                      compressed_dim=row_name if format == 'csr' else dual_name,
                                      uncompressed_dim=dual_name if format == 'csr' else row_name)
    if format == 'compact':
        order = torch.sort(rows, stable=True).indices
        rows, cols, vals = rows[order], cols[order], vals[order]
        counts = torch.bincount(rows, minlength=n_rows)
        cap = max(1, int(counts.max())) if rows.numel() else 1
        slot = torch.arange(rows.shape[0], device=rows.device) - (torch.cumsum(counts, 0) - counts)[rows]
        col_arr = torch.full((n_rows, cap), -1, dtype=torch.int32, device=rows.device)
        val_arr = torch.zeros((n_rows, cap), dtype=vals.dtype, device=vals.device)
        col_arr[rows, slot] = cols.to(torch.int32)
        val_arr[rows, slot] = vals
        cap_shape = Shape((coo._dense_shape.get_dim(row_name), Dim('~entries_per_row', cap, DUAL, None)))
        return CompactSparseTensor(Tensor(col_arr, cap_shape), Tensor(val_arr, cap_shape), coo._dense_shape)
    raise ValueError(f"unknown sparse format {format!r}")


def stored_indices(x: SparseCooTensor, list_dim=instance('entries'), index_dim=channel('index')) -> Tensor:
    assert is_sparse(x)
    labels = x._indices.shape.get_labels('sparse_idx')
    return Tensor(x._indices.native(('entries', 'sparse_idx')),
                  instance(entries=x.entries) & index_dim.with_size(len(labels), labels))


def stored_values(x: SparseCooTensor, list_dim=instance('entries')) -> Tensor:
    assert is_sparse(x)
    return x._values


def matrix_from_function(f, *args, auto_compress=True, **kwargs):
    """The sparse matrix and bias of an affine function, ``f(x) == matrix @
    x + bias`` (phiml's `matrix_from_function`): rows over the output's dims,
    columns over the duals of the input's. The Jacobian is taken densely by
    reverse-mode autograd (one vectorised backward per output entry), exact
    as JAX's `jax.jacfwd`, then sparsified — for moderate sizes."""
    x0 = args[0]
    rest = args[1:]
    in_shape = x0.shape
    zero = torch.zeros(tuple(in_shape.sizes), dtype=x0.torch().dtype, device=x0.torch().device)
    bias = f(Tensor(zero, in_shape), *rest, **kwargs)
    out_shape = bias.shape
    n_in = max(in_shape.volume, 1)

    def g(vec):
        y = f(Tensor(vec.reshape(tuple(in_shape.sizes)), in_shape), *rest, **kwargs)
        return (y - bias).torch(out_shape.names).reshape(-1)

    J = torch.autograd.functional.jacobian(g, zero.reshape(n_in), vectorize=True)  # (n_out, n_in)
    nz = torch.nonzero(J != 0) if auto_compress else torch.nonzero(torch.ones_like(J, dtype=torch.bool))
    vals = J[nz[:, 0], nz[:, 1]]
    out_coords = np.unravel_index(nz[:, 0].cpu().numpy(), tuple(out_shape.sizes)) if out_shape.rank else ()
    in_coords = np.unravel_index(nz[:, 1].cpu().numpy(), tuple(in_shape.sizes)) if in_shape.rank else ()
    coords = torch.from_numpy(np.stack(list(out_coords) + list(in_coords), -1).astype(np.int32)).to(J.device)
    dual_in = dual(**{n: s for n, s in zip(in_shape.names, in_shape.sizes)})
    idx = Tensor(coords, instance(entries=coords.shape[0]) & channel(sparse_idx=tuple(out_shape.names + dual_in.names)))
    matrix = SparseCooTensor(idx, Tensor(vals.detach(), instance(entries=vals.shape[0])), out_shape & dual_in)
    return matrix, bias
