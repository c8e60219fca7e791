"""The port's data pipeline (neuronika_tpu_torch/data/) against the JAX
package's on the CPU: the same arrays, bit for bit, from the CSV loaders
(headers, delimiters, label columns, per-record closures, files), the
batches with and without `drop_last`, `shuffle_with_seed`, the k-folds,
`split` and `lm_windows`; and `prefetch_to_device`, which yields the
batches as tensors on `config.device`."""

import numpy as np
import pytest
import torch

import neuronika_tpu_torch as nk
from neuronika_tpu import data as jdata
from neuronika_tpu_torch import data

CSV = "a,b,c\n1,2,3\n4,5,6\n7,8,9\n10,11,12\n13,14,15"
CSV_LABELED = (
    "Paw_size,Tail_length,Weight,Animal\n"
    "0.2,5.0,15.0,1\n"
    "0.08,12.0,4.0,2\n"
    "0.07,13.0,5.0,2\n"
    "0.05,3.0,0.8,3\n"
    "0.11,7.5,2.5,1"
)


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    yield
    nk.config.device = old


def same(a, b):
    """Bit for bit: dtype, shape and values."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def both(build):
    """build(module) in each package."""
    return build(jdata), build(data)


def _mapper(pair):
    rec, label = pair
    return rec, [{"Dog": 1.0, "Cat": 2.0}.get(label, 3.0)]


LOADERS = {
    "plain": lambda m: m.DataLoader.default().from_reader(CSV, 3),
    "shape": lambda m: m.DataLoader.default().from_reader(CSV, (3, 1)),
    "no-headers": lambda m: m.DataLoader.default().without_headers()
    .from_reader("1,2\n3,4", 2),
    "delimiter": lambda m: m.DataLoader.default().without_headers()
    .with_delimiter(";").from_reader("1;2\n3;4", 2),
    "bytes": lambda m: m.DataLoader.default().from_reader(CSV.encode(), 3),
    "fn": lambda m: m.DataLoader.default().from_reader_fn(
        CSV, 3, lambda r: [v * 2 for v in r]),
}
LABELED = {
    "labels": lambda m: m.DataLoader.default().with_labels([3])
    .from_reader(CSV_LABELED, 3, 1),
    "two-labels": lambda m: m.DataLoader.default().with_labels([0, 2])
    .from_reader(CSV_LABELED, 2, 2),
    "fn": lambda m: m.DataLoader.default().with_labels([2]).from_reader_fn(
        "x,y,animal\n1,2,Dog\n3,4,Cat\n5,6,Cow", 2, 1, _mapper),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_loader_matches_jax(name):
    a, b = both(LOADERS[name])
    same(b.records(), a.records())
    assert b.len() == len(b) == a.len() and not b.is_empty()


@pytest.mark.parametrize("name", list(LABELED))
def test_labeled_loader_matches_jax(name):
    a, b = both(LABELED[name])
    same(b.records(), a.records())
    same(b.labels(), a.labels())


def test_csv_files_match_jax(tmp_path):
    """The port parses files in Python; JAX may take its C++ path: the
    arrays are the same."""
    path = tmp_path / "d.csv"
    path.write_text(CSV + "\n")
    lpath = tmp_path / "l.csv"
    lpath.write_text(CSV_LABELED)
    a, b = both(lambda m: m.DataLoader.default().from_csv(str(path), 3))
    same(b.records(), a.records())
    a, b = both(lambda m: m.DataLoader.default().from_csv_fn(
        str(path), 3, lambda r: r[::-1]))
    same(b.records(), a.records())
    a, b = both(lambda m: m.DataLoader.default().with_labels([3])
                .from_csv(str(lpath), 3, 1))
    same(b.records(), a.records())
    same(b.labels(), a.labels())
    a, b = both(lambda m: m.DataLoader.default().with_labels([3])
                .from_csv_fn(str(lpath), 3, 1,
                             lambda p: (p[0], [p[1] + 1.0])))
    same(b.labels(), a.labels())


@pytest.mark.parametrize("size,drop", [(2, False), (2, True), (5, False),
                                       (7, True)])
def test_batches_match_jax(size, drop):
    for loader in (LOADERS["plain"], LABELED["labels"]):
        batches = []
        for ds in both(loader):
            it = ds.batch(size)
            if drop:
                it = it.drop_last()
            batches.append((len(it), list(it)))
        assert batches[0][0] == batches[1][0] == len(batches[1][1])
        for x, y in zip(batches[1][1], batches[0][1]):
            if isinstance(x, tuple):
                same(x[0], y[0])
                same(x[1], y[1])
            else:
                same(x, y)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40])
def test_shuffle_with_seed_matches_jax(seed):
    a, b = both(LOADERS["plain"])
    same(b.shuffle_with_seed(seed).records(),
         a.shuffle_with_seed(seed).records())
    a, b = both(LABELED["labels"])
    b.shuffle_with_seed(seed)
    a.shuffle_with_seed(seed)
    same(b.records(), a.records())
    same(b.labels(), a.labels())


def test_unseeded_shuffle_keeps_rows_and_pairs():
    ds = LABELED["labels"](data)
    before = {tuple(r) + tuple(l) for r, l in zip(ds.records(), ds.labels())}
    ds.shuffle()
    assert {tuple(r) + tuple(l)
            for r, l in zip(ds.records(), ds.labels())} == before
    plain = LOADERS["plain"](data)
    rows = sorted(map(tuple, plain.records()))
    assert sorted(map(tuple, plain.shuffle().records())) == rows


@pytest.mark.parametrize("k", [2, 3, 5])
def test_kfolds_match_jax(k):
    a, b = both(LOADERS["plain"])
    fa, fb = list(a.kfold(k)), list(b.kfold(k))
    assert len(fa) == len(fb) == k
    for (tr_a, te_a), (tr_b, te_b) in zip(fa, fb):
        same(tr_b, tr_a)
        same(te_b, te_a)
    a, b = both(LABELED["labels"])
    for fold_a, fold_b in zip(a.kfold(k), b.kfold(k)):
        for x, y in zip(fold_b, fold_a):
            same(x[0], y[0])
            same(x[1], y[1])
    recs = np.arange(10.0).reshape(10, 1).astype(np.float32)
    for i in range(4):
        for x, y in zip(data.SetKFold(recs, 4).compute_fold(i),
                        jdata.SetKFold(recs, 4).compute_fold(i)):
            same(x, y)


def test_kfold_validation():
    ds = LOADERS["plain"](data)
    for bad in (1, 6):
        with pytest.raises(ValueError):
            ds.kfold(bad)
    with pytest.raises(ValueError):
        data.LabeledKFold(np.zeros((3, 1)), np.zeros((4, 1)), 2)


def test_split_matches_jax():
    for loader, lengths in ((LOADERS["plain"], [3, 2]),
                            (LABELED["labels"], [1, 4])):
        a, b = both(loader)
        for x, y in zip(b.split(lengths), a.split(lengths)):
            same(x.records(), y.records())
            if hasattr(x, "labels"):
                same(x.labels(), y.labels())
        with pytest.raises(ValueError):
            b.split([1, 1])


@pytest.mark.parametrize("n,seq,stride", [(100, 10, 0), (50, 16, 8),
                                          (17, 16, 0), (64, 7, 3)])
def test_lm_windows_matches_jax(n, seq, stride):
    ids = np.random.default_rng(n).integers(0, 1000, n)
    for x, y in zip(data.lm_windows(ids, seq, stride),
                    jdata.lm_windows(ids, seq, stride)):
        same(x, y)
    with pytest.raises(ValueError, match="shorter than one"):
        data.lm_windows(list(range(8)), 16)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_prefetch_to_device(size):
    """Batches come out as tensors on config.device, in order, arrays and
    (records, labels) tuples alike."""
    ds = LOADERS["plain"](data)
    out = list(data.prefetch_to_device(ds.batch(2), size=size))
    assert len(out) == 3 and all(isinstance(t, torch.Tensor) for t in out)
    assert all(t.device == torch.device("cpu") for t in out)
    same(torch.cat(out).numpy(), ds.records())
    lds = LABELED["labels"](data)
    pairs = list(data.prefetch_to_device(lds.batch(2), size=size,
                                         device="cpu"))
    same(torch.cat([x for x, _ in pairs]).numpy(), lds.records())
    same(torch.cat([y for _, y in pairs]).numpy(), lds.labels())
    assert list(data.prefetch_to_device(iter([]))) == []


def test_prefetch_to_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = LOADERS["plain"](data)
    with pytest.raises(RuntimeError, match="is_available"):
        next(data.prefetch_to_device(ds.batch(2), device="cuda"))
    nk.config.device = "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        next(data.prefetch_to_device(ds.batch(2)))
