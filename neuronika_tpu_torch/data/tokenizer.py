"""Byte-level BPE tokenizer: training, encode, decode, serde (counterpart
of `neuronika_tpu/data/tokenizer.py`, its pure-Python path; the JAX
package's C++ encoder is not ported, ROADMAP.md queue 1 item 2).

The GPT-2 byte-level BPE family:

* the base alphabet is the 256 bytes: any UTF-8 input round-trips
  exactly, no <unk> ever;
* pretokenization splits " ?\\S+|\\s+" so merges never cross word
  boundaries (spaces attach to the FOLLOWING word, GPT-2 style);
* training iteratively merges the most frequent adjacent pair (ties to
  the lower pair ids);
* encoding applies merges greedily by rank (lowest-rank pair first).

Both packages train the same merges from the same texts, give the same
ids and read each other's saved files (`save`/`load`, JSON).
"""
from __future__ import annotations

import json
import re
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# " ?\S+" attaches a single leading space to the word; "\s+(?!\S)"
# (GPT-2's lookahead) makes a whitespace run leave its LAST space to
# the following word.
_PRETOK = re.compile(rb" ?\S+|\s+(?!\S)|\s+")


def _pretokenize(data: bytes) -> List[bytes]:
    return _PRETOK.findall(data)


class BpeTokenizer:
    """ids 0..255 are the raw bytes; each merge appends one id; special
    tokens occupy the top of the vocabulary."""

    def __init__(self, merges: Sequence[Tuple[int, int]],
                 special_tokens: Sequence[str] = ()) -> None:
        self.merges: List[Tuple[int, int]] = [tuple(m) for m in merges]
        self.ranks: Dict[Tuple[int, int], int] = {
            tuple(m): i for i, m in enumerate(self.merges)
        }
        # merge i produces id 256 + i
        self.special_tokens = list(special_tokens)
        self._special_ids = {
            s: 256 + len(self.merges) + i
            for i, s in enumerate(self.special_tokens)
        }
        self._encode_word = lru_cache(maxsize=65536)(self._encode_word_raw)
        self._table: Optional[List[bytes]] = None

    # ------------------------------------------------------------ training
    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int,
              special_tokens: Sequence[str] = ()) -> "BpeTokenizer":
        """Classic BPE training: count pretoken frequencies once, then
        `vocab_size - 256 - len(special)` rounds of merge-the-most-
        frequent-adjacent-pair. Deterministic (ties break on the lower
        pair ids)."""
        n_merges = vocab_size - 256 - len(special_tokens)
        if n_merges < 0:
            raise ValueError(
                f"vocab_size {vocab_size} < 256 + {len(special_tokens)} "
                "special tokens")
        words: Dict[Tuple[int, ...], int] = {}
        for t in texts:
            for w in _pretokenize(t.encode("utf-8")):
                key = tuple(w)
                words[key] = words.get(key, 0) + 1

        merges: List[Tuple[int, int]] = []
        words_l = [[list(w), f] for w, f in words.items()]
        for mi in range(n_merges):
            counts: Dict[Tuple[int, int], int] = {}
            for w, f in words_l:
                for a, b in zip(w, w[1:]):
                    counts[(a, b)] = counts.get((a, b), 0) + f
            if not counts:
                break
            best = max(counts.items(), key=lambda kv: (kv[1], (-kv[0][0],
                                                              -kv[0][1])))
            if best[1] < 2:
                break  # nothing repeats — further merges are noise
            pair = best[0]
            new_id = 256 + mi
            merges.append(pair)
            for item in words_l:
                w = item[0]
                if len(w) < 2:
                    continue
                out = []
                i = 0
                while i < len(w):
                    if (i + 1 < len(w) and w[i] == pair[0]
                            and w[i + 1] == pair[1]):
                        out.append(new_id)
                        i += 2
                    else:
                        out.append(w[i])
                        i += 1
                item[0] = out
        return cls(merges, special_tokens)

    # ------------------------------------------------------------ encoding
    def _encode_word_raw(self, word: bytes) -> Tuple[int, ...]:
        ids = list(word)
        ranks = self.ranks
        while len(ids) > 1:
            best_rank = None
            best_i = -1
            for i, pair in enumerate(zip(ids, ids[1:])):
                r = ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            ids[best_i:best_i + 2] = [256 + best_rank]
        return tuple(ids)

    def encode(self, text: str) -> List[int]:
        if self.special_tokens:
            # split on special tokens first — they map to their reserved
            # ids and are never merged through
            pat = "(" + "|".join(re.escape(s)
                                 for s in self.special_tokens) + ")"
            out: List[int] = []
            for seg in re.split(pat, text):
                if seg in self._special_ids:
                    out.append(self._special_ids[seg])
                elif seg:
                    out.extend(self._encode_plain(seg.encode("utf-8")))
            return out
        return self._encode_plain(text.encode("utf-8"))

    def _encode_plain(self, data: bytes) -> List[int]:
        out: List[int] = []
        for w in _pretokenize(data):
            out.extend(self._encode_word(w))
        return out

    def encode_batch(self, texts: Iterable[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    # ------------------------------------------------------------ decoding
    def _id_bytes(self) -> List[bytes]:
        if self._table is None:
            table: List[bytes] = [bytes([i]) for i in range(256)]
            for a, b in self.merges:
                table.append(table[a] + table[b])
            for s in self.special_tokens:
                table.append(s.encode("utf-8"))
            self._table = table
        return self._table

    def decode(self, ids: Iterable[int]) -> str:
        table = self._id_bytes()
        return b"".join(table[i] for i in ids).decode("utf-8",
                                                      errors="replace")

    # ------------------------------------------------------------- helpers
    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges) + len(self.special_tokens)

    def special_id(self, token: str) -> int:
        return self._special_ids[token]

    # --------------------------------------------------------------- serde
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges,
                       "special_tokens": self.special_tokens}, f)

    @classmethod
    def load(cls, path: str) -> "BpeTokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls([tuple(m) for m in d["merges"]], d["special_tokens"])
