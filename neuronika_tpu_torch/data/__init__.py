"""Datasets and CSV loading (counterpart of `neuronika_tpu/data/__init__.py`).

A host-side pipeline on numpy: datasets hold f32 arrays, and batching,
splitting and shuffling happen on the host; a batch reaches the card when
the training loop wraps it with `from_ndarray`, or ahead of time through
`prefetch_to_device`. The shuffles draw from `np.random.default_rng(seed)`,
as JAX's do, so `shuffle_with_seed` gives the same order in both packages.
CSV is parsed by Python's `csv` module; the JAX package's C++ fast path is
not ported.

* `DataLoader`, set up by chained calls: `without_headers`,
  `with_delimiter`, `with_labels([...]) -> LabeledDataLoader`, then
  `from_csv`, `from_reader`, `from_csv_fn` or `from_reader_fn`.
* `Dataset` / `LabeledDataset`: `records`, `labels`, `len`, `is_empty`,
  `batch(size)`, `kfold(k)`, `split(lengths)`, `shuffle`,
  `shuffle_with_seed`.
* `Batch`/`LabeledBatch` with `drop_last()`; `KFold`/`LabeledKFold`
  consecutive-fold cross validation; `lm_windows` for next-token windows.
* `BpeTokenizer` (`data/tokenizer.py`), the byte-level BPE tokenizer.

The `*_fn` loaders hand the per-record closure the parsed field values
(numeric fields as floats, everything else as str).
"""

from __future__ import annotations

import collections
import csv as _csv
import io
import itertools
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .tokenizer import BpeTokenizer

__all__ = [
    "DataLoader", "LabeledDataLoader", "Dataset", "LabeledDataset",
    "Batch", "LabeledBatch", "KFold", "LabeledKFold", "SetKFold",
    "prefetch_to_device", "lm_windows", "BpeTokenizer",
]


def lm_windows(ids, seq_len: int, stride: int = 0):
    """Slice a 1-D token stream into (tokens, targets) next-token
    windows: tokens[i] = ids[s:s+L], targets[i] = ids[s+1:s+L+1], with
    window starts every `stride` tokens (default: non-overlapping).
    Returns two int32 arrays of shape (n_windows, seq_len) — the
    standard LM pre-training batcher (see examples/text_pipeline.py)."""
    ids = np.asarray(ids, np.int32).reshape(-1)
    if stride <= 0:
        stride = seq_len
    if len(ids) < seq_len + 1:
        raise ValueError(
            f"stream of {len(ids)} tokens is shorter than one "
            f"window ({seq_len} + 1)")
    starts = range(0, len(ids) - seq_len, stride)
    toks = np.stack([ids[s:s + seq_len] for s in starts])
    tgts = np.stack([ids[s + 1:s + seq_len + 1] for s in starts])
    return toks, tgts


def _coerce(field: str):
    try:
        return float(field)
    except ValueError:
        return field


def _rows_from_reader(src, delimiter: str, has_headers: bool) -> List[List[str]]:
    if isinstance(src, bytes):
        src = src.decode()
    if isinstance(src, str):
        handle = io.StringIO(src)
    else:
        handle = src
    rows = list(_csv.reader(handle, delimiter=delimiter))
    if has_headers and rows:
        rows = rows[1:]
    return [r for r in rows if r]


def _stack(rows: List[Sequence[float]], shape: Tuple[int, ...]) -> np.ndarray:
    arr = np.asarray(rows, dtype=np.float32)
    return arr.reshape((len(rows), *shape))


def _shape_tuple(shape) -> Tuple[int, ...]:
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


class DataLoader:
    """CSV -> `Dataset`, set up by chained calls."""

    def __init__(self) -> None:
        self._headers = True
        self._delimiter = ","

    @classmethod
    def default(cls) -> "DataLoader":
        return cls()

    def without_headers(self) -> "DataLoader":
        self._headers = False
        return self

    def with_delimiter(self, delimiter: str) -> "DataLoader":
        self._delimiter = delimiter
        return self

    def with_labels(self, labels: Sequence[int]) -> "LabeledDataLoader":
        ld = LabeledDataLoader(labels)
        ld._headers = self._headers
        ld._delimiter = self._delimiter
        return ld

    # ------------------------------------------------------------- loading
    def from_reader(self, src, shape) -> "Dataset":
        shape = _shape_tuple(shape)
        rows = _rows_from_reader(src, self._delimiter, self._headers)
        data = [[float(f) for f in r] for r in rows]
        return Dataset(_stack(data, shape))

    def from_csv(self, src: str, shape) -> "Dataset":
        with open(src, "r", newline="") as f:
            return self.from_reader(f, shape)

    def from_reader_fn(self, src, shape, fn: Callable) -> "Dataset":
        shape = _shape_tuple(shape)
        rows = _rows_from_reader(src, self._delimiter, self._headers)
        data = [list(fn([_coerce(f) for f in r])) for r in rows]
        return Dataset(_stack(data, shape))

    def from_csv_fn(self, src: str, shape, fn: Callable) -> "Dataset":
        with open(src, "r", newline="") as f:
            return self.from_reader_fn(f, shape, fn)


class LabeledDataLoader:
    """CSV -> `LabeledDataset`, set up by chained calls; the `labels`
    column indices are split out of each record."""

    def __init__(self, labels: Sequence[int]) -> None:
        self._labels = sorted(int(i) for i in labels)
        self._headers = True
        self._delimiter = ","

    def without_headers(self) -> "LabeledDataLoader":
        self._headers = False
        return self

    def with_delimiter(self, delimiter: str) -> "LabeledDataLoader":
        self._delimiter = delimiter
        return self

    def _split_row(self, row: Sequence) -> Tuple[list, list]:
        label_set = set(self._labels)
        record = [v for i, v in enumerate(row) if i not in label_set]
        label = [row[i] for i in self._labels]
        return record, label

    def from_reader(self, src, record_shape, label_shape) -> "LabeledDataset":
        rs, ls = _shape_tuple(record_shape), _shape_tuple(label_shape)
        rows = _rows_from_reader(src, self._delimiter, self._headers)
        recs, labs = [], []
        for r in rows:
            rec, lab = self._split_row(r)
            recs.append([float(f) for f in rec])
            labs.append([float(f) for f in lab])
        return LabeledDataset(_stack(recs, rs), _stack(labs, ls))

    def from_csv(self, src: str, record_shape, label_shape) -> "LabeledDataset":
        with open(src, "r", newline="") as f:
            return self.from_reader(f, record_shape, label_shape)

    def from_reader_fn(self, src, record_shape, label_shape, fn: Callable) -> "LabeledDataset":
        rs, ls = _shape_tuple(record_shape), _shape_tuple(label_shape)
        rows = _rows_from_reader(src, self._delimiter, self._headers)
        recs, labs = [], []
        for r in rows:
            rec, lab = self._split_row([_coerce(f) for f in r])
            if len(lab) == 1:
                lab = lab[0]
            out_rec, out_lab = fn((rec, lab))
            recs.append(list(out_rec))
            labs.append(list(out_lab))
        return LabeledDataset(_stack(recs, rs), _stack(labs, ls))

    def from_csv_fn(self, src: str, record_shape, label_shape, fn: Callable) -> "LabeledDataset":
        with open(src, "r", newline="") as f:
            return self.from_reader_fn(f, record_shape, label_shape, fn)


class Dataset:
    """Owned record tensor."""

    def __init__(self, records: np.ndarray) -> None:
        self._records = np.asarray(records, dtype=np.float32)

    def records(self) -> np.ndarray:
        return self._records

    def len(self) -> int:
        return self._records.shape[0]

    def __len__(self) -> int:
        return self.len()

    def is_empty(self) -> bool:
        return self.len() == 0

    def batch(self, size: int) -> "Batch":
        return Batch(self._records, size)

    def kfold(self, k: int) -> "KFold":
        return KFold(self._records, k)

    def split(self, lengths: Sequence[int]) -> List["Dataset"]:
        if sum(lengths) != self.len():
            raise ValueError("split lengths must sum to the dataset length")
        out, off = [], 0
        for l in lengths:
            out.append(Dataset(self._records[off:off + l]))
            off += l
        return out

    def shuffle(self) -> "Dataset":
        rng = np.random.default_rng()
        rng.shuffle(self._records, axis=0)
        return self

    def shuffle_with_seed(self, seed: int) -> "Dataset":
        rng = np.random.default_rng(seed)
        rng.shuffle(self._records, axis=0)
        return self


class LabeledDataset:
    """Paired record/label tensors."""

    def __init__(self, records: np.ndarray, labels: np.ndarray) -> None:
        self._records = np.asarray(records, dtype=np.float32)
        self._labels = np.asarray(labels, dtype=np.float32)
        if self._records.shape[0] != self._labels.shape[0]:
            raise ValueError("records and labels must have the same length")

    def records(self) -> np.ndarray:
        return self._records

    def labels(self) -> np.ndarray:
        return self._labels

    def len(self) -> int:
        return self._records.shape[0]

    def __len__(self) -> int:
        return self.len()

    def is_empty(self) -> bool:
        return self.len() == 0

    def batch(self, size: int) -> "LabeledBatch":
        return LabeledBatch(self._records, self._labels, size)

    def kfold(self, k: int) -> "LabeledKFold":
        return LabeledKFold(self._records, self._labels, k)

    def split(self, lengths: Sequence[int]) -> List["LabeledDataset"]:
        if sum(lengths) != self.len():
            raise ValueError("split lengths must sum to the dataset length")
        out, off = [], 0
        for l in lengths:
            out.append(
                LabeledDataset(self._records[off:off + l], self._labels[off:off + l])
            )
            off += l
        return out

    def shuffle(self) -> "LabeledDataset":
        return self.shuffle_with_seed(np.random.default_rng().integers(2**63))

    def shuffle_with_seed(self, seed: int) -> "LabeledDataset":
        perm = np.random.default_rng(seed).permutation(self.len())
        self._records = self._records[perm]
        self._labels = self._labels[perm]
        return self


class Batch:
    """Row-chunk iterator."""

    def __init__(self, records: np.ndarray, size: int) -> None:
        self._records = records
        self._size = int(size)
        self._drop_last = False

    def drop_last(self) -> "Batch":
        self._drop_last = True
        return self

    def __iter__(self):
        n = self._records.shape[0]
        stop = (n // self._size) * self._size if self._drop_last else n
        for i in range(0, stop, self._size):
            yield self._records[i:i + self._size]

    def __len__(self) -> int:
        n = self._records.shape[0]
        return n // self._size if self._drop_last else -(-n // self._size)


class LabeledBatch:
    """(records, labels) chunk iterator."""

    def __init__(self, records: np.ndarray, labels: np.ndarray, size: int) -> None:
        self._records = records
        self._labels = labels
        self._size = int(size)
        self._drop_last = False

    def drop_last(self) -> "LabeledBatch":
        self._drop_last = True
        return self

    def __iter__(self):
        n = self._records.shape[0]
        stop = (n // self._size) * self._size if self._drop_last else n
        for i in range(0, stop, self._size):
            yield self._records[i:i + self._size], self._labels[i:i + self._size]

    def __len__(self) -> int:
        n = self._records.shape[0]
        return n // self._size if self._drop_last else -(-n // self._size)


class SetKFold:
    """Fold-view over one tensor: fold i yields (train, test) along axis 0.

    The reference's math: ``step = 1 + (len-1)//k`` (ceil
    division), fold i covers ``[step*i, min(len, step*i+step))`` — trailing
    folds may be short or (for k > ceil(len/step)) empty."""

    def __init__(self, source: np.ndarray, k: int) -> None:
        if k < 2:
            raise ValueError("error: folds must be > 2.")
        n = source.shape[0]
        assert n != 0, "no record provided"
        self._source = source
        self._step = 1 + (n - 1) // int(k)
        self._axis_len = n

    def compute_fold(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        start = self._step * i
        stop = min(self._axis_len, start + self._step)
        test = self._source[start:stop]
        train = np.concatenate(
            [self._source[:start], self._source[stop:]], axis=0
        )
        return train, test


class KFold:
    """Consecutive-fold cross validation: fold i yields (train, test), as
    `SetKFold` cuts it."""

    def __init__(self, records: np.ndarray, k: int) -> None:
        if k < 2 or k > records.shape[0]:
            raise ValueError("k must be between 2 and the dataset length")
        self._records = SetKFold(records, k)
        self._k = int(k)

    def compute_fold(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._records.compute_fold(i)

    def __iter__(self):
        for i in range(self._k):
            yield self.compute_fold(i)


class LabeledKFold:
    """K-fold over paired records/labels."""

    def __init__(self, records: np.ndarray, labels: np.ndarray, k: int) -> None:
        if records.shape[0] != labels.shape[0]:
            raise ValueError("records and labels must have equal length")
        self._records = KFold(records, k)
        self._labels = KFold(labels, k)
        self._k = int(k)

    def compute_fold(self, i: int):
        tr_r, te_r = self._records.compute_fold(i)
        tr_l, te_l = self._labels.compute_fold(i)
        return (tr_r, tr_l), (te_r, te_l)

    def __iter__(self):
        for i in range(self._k):
            yield self.compute_fold(i)


def _place(batch, device, pin: bool):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_place(b, device, pin) for b in batch)
    t = torch.as_tensor(np.asarray(batch))
    if pin:
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Wrap a host batch iterator so that batches are moved to `device`
    (`config.device` when None) `size` steps ahead: on the card each batch
    is copied from pinned host memory with `non_blocking=True`, so the
    copy overlaps the steps before it. Takes plain arrays or the (records,
    labels) tuples of `Batch`/`LabeledBatch`, and yields tensors."""
    from ..config import config
    from ..device import resolve

    dev = resolve(config.device if device is None else device)
    pin = dev.type == "cuda"
    it = iter(iterator)
    queue = collections.deque(_place(b, dev, pin)
                              for b in itertools.islice(it, size))
    while queue:
        out = queue.popleft()
        queue.extend(_place(b, dev, pin) for b in itertools.islice(it, 1))
        yield out
