"""Character-level RNN (counterpart of `neuronika_tpu/models/rnn.py`): an
LSTMCell or GRUCell stepped in a Python loop, the graph rebuilt for each
batch, as the reference's define-by-run contract has it. Graphs of the same
length reuse the executor's cached step list."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import from_ndarray, zeros
from .. import nn
from ..variable import Reduction, Var, VarDiff


def one_hot(ids: np.ndarray, vocab: int) -> np.ndarray:
    out = np.zeros((*ids.shape, vocab), dtype=np.float32)
    np.put_along_axis(out, ids[..., None].astype(np.int64), 1.0, axis=-1)
    return out


class CharRNN:
    """One-hot input -> {LSTM|GRU}Cell loop -> Linear readout per step."""

    def __init__(self, vocab: int, hidden: int, cell: str = "lstm") -> None:
        self.vocab = vocab
        self.hidden = hidden
        self.kind = cell
        self.status = nn.ModelStatus.default()
        if cell == "lstm":
            self.cell = self.status.register(nn.LSTMCell(vocab, hidden))
        elif cell == "gru":
            self.cell = self.status.register(nn.GRUCell(vocab, hidden))
        else:
            raise ValueError("cell must be 'lstm' or 'gru'")
        self.readout = self.status.register(nn.Linear(hidden, vocab))

    def parameters(self) -> List[VarDiff]:
        return self.status.parameters()

    def forward_sequence(self, ids: np.ndarray) -> List[VarDiff]:
        """ids (B, T) int -> per-step logits [(B, vocab)] * T, the graph
        rebuilt at every call."""
        B, T = ids.shape
        state: Tuple[Var, Var] = (zeros((B, self.hidden)),
                                  zeros((B, self.hidden)))
        logits = []
        xs = one_hot(ids, self.vocab)
        for t in range(T):
            x = from_ndarray(xs[:, t])
            if self.kind == "lstm":
                state = self.cell.forward(state, x)
                h_t = state[1]
            else:
                h_t = self.cell.forward(state[1], x)
                state = (state[0], h_t)
            logits.append(self.readout.forward(h_t))
        return logits

    def loss(self, ids: np.ndarray, targets: np.ndarray) -> VarDiff:
        """Mean softmax cross-entropy over all steps, from the reference's
        NLL (class axis first) and log_softmax."""
        total = None
        for t, step_logits in enumerate(self.forward_sequence(ids)):
            logp = step_logits.log_softmax(1).t()
            tgt = from_ndarray(targets[:, t].astype(np.float32))
            step_loss = logp.nll(tgt, Reduction.Sum)
            total = step_loss if total is None else total + step_loss
        return total * (1.0 / (ids.shape[0] * ids.shape[1]))
