"""The port's byte-level BPE tokenizer (neuronika_tpu_torch/data/
tokenizer.py) against the JAX package's on the CPU: the same corpus trains
the same merges; encode, decode, `encode_batch`, special-token ids and the
vocabulary size agree (JAX's encoder is its C++ path where built, the
port's is Python); a file saved by either package loads in the other."""

import pytest

from neuronika_tpu.data import BpeTokenizer as JBpe
from neuronika_tpu_torch.data import BpeTokenizer as TBpe

CORPUS = [
    "the quick brown fox jumps over the lazy dog. " * 6,
    "she sells sea shells by the sea shore;\n\tthe shells she sells are "
    "sea shells   for sure. ",
    "naïve café déjà vu — ünïcödé text, 数字 1234 and emoji 🙂🙂. " * 3,
]
SPECIALS = ["<|end|>", "<|pad|>"]
TEXTS = [
    "the quick brown fox<|end|>she sells<|pad|><|pad|>",
    "  leading spaces and trailing   ",
    "ünïcödé déjà 🙂 never seen: zebra xylophone",
    "",
    "<|end|>",
]


@pytest.fixture(scope="module")
def pair():
    return (JBpe.train(CORPUS, vocab_size=400, special_tokens=SPECIALS),
            TBpe.train(CORPUS, vocab_size=400, special_tokens=SPECIALS))


def test_training_gives_jax_merges(pair):
    j, t = pair
    assert t.merges == j.merges
    assert t.vocab_size == j.vocab_size
    assert [t.special_id(s) for s in SPECIALS] == [j.special_id(s)
                                                    for s in SPECIALS]


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_encode_and_decode_match_jax(pair, i):
    j, t = pair
    ids = t.encode(TEXTS[i])
    assert ids == j.encode(TEXTS[i])
    assert t.decode(ids) == j.decode(ids) == TEXTS[i]


def test_encode_batch_matches_jax(pair):
    j, t = pair
    assert t.encode_batch(TEXTS) == j.encode_batch(TEXTS)


def test_files_cross_both_ways(pair, tmp_path):
    j, t = pair
    j.save(str(tmp_path / "j.json"))
    t.save(str(tmp_path / "t.json"))
    tj = TBpe.load(str(tmp_path / "j.json"))
    jt = JBpe.load(str(tmp_path / "t.json"))
    assert tj.merges == j.merges and jt.merges == t.merges
    assert tj.special_tokens == jt.special_tokens == SPECIALS
    assert (tmp_path / "j.json").read_text() == (
        tmp_path / "t.json").read_text()
    assert tj.encode_batch(TEXTS) == jt.encode_batch(TEXTS)


def test_small_vocab_refused_like_jax():
    for cls in (JBpe, TBpe):
        with pytest.raises(ValueError, match="vocab_size"):
            cls.train(CORPUS, vocab_size=257, special_tokens=SPECIALS)
