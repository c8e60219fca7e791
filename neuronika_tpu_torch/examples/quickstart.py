"""Quickstart: train a small MLP on a CSV dataset (twin of the JAX
package's `examples/quickstart.py`: the same dataset, the same 3->5->5->1
network, SGD with an L2 penalty, batches of 2 with `drop_last`, and the
model reloaded from JSON).

    python -m neuronika_tpu_torch.examples.quickstart
"""

from __future__ import annotations

import json

import numpy as np

import neuronika_tpu_torch as nk
from neuronika_tpu_torch import data, nn, optim, utils
from neuronika_tpu_torch.examples import on_device

CSV = (
    "Paw_size,Tail_length,Weight,Animal\n"
    "0.2,5.0,15.0,Dog\n"
    "0.08,12.0,4.0,Cat\n"
    "0.07,13.0,5.0,Cat\n"
    "0.05,3.0,0.8,Mouse"
)


class NeuralNetwork:
    def __init__(self):
        self.status = nn.ModelStatus.default()
        self.lin1 = self.status.register(nn.Linear(3, 5))
        self.lin2 = self.status.register(nn.Linear(5, 5))
        self.lin3 = self.status.register(nn.Linear(5, 1))

    def layers(self):
        return {"lin1": self.lin1, "lin2": self.lin2, "lin3": self.lin3}

    def parameters(self):
        return self.status.parameters()

    def forward(self, input):
        out1 = self.lin1.forward(input).relu()
        out2 = self.lin2.forward(out1).relu()
        return self.lin3.forward(out2)


def load_dataset():
    """The CSV with its label column mapped to numbers."""
    def mapper(pair):
        record, label = pair
        return record, [{"Dog": 1.0, "Cat": 2.0}.get(label, 3.0)]

    return (data.DataLoader.default().with_labels([3])
            .from_reader_fn(CSV, 3, 1, mapper))


def main(device=None, steps: int = 5, seed: int = 0, state=None,
         verbose: bool = True):
    """Train for `steps` epochs; returns each epoch's summed loss. The
    model is saved as JSON and loaded into a fresh one, as the reference
    does; `state` (a `utils.state_dict` of layers lin1-lin3, for example a
    JAX model's) is loaded instead when given. Each epoch shuffles the
    dataset with a seed drawn from `np.random.default_rng(seed)`."""
    with on_device(device):
        dataset = load_dataset()
        model = NeuralNetwork()
        blob = json.dumps(utils.state_dict(model.layers()) if state is None
                          else state)
        model = NeuralNetwork()
        utils.load_state_dict(model.layers(), json.loads(blob))

        optimizer = optim.SGD(0.01, optim.L2(0.0))
        optimizer.register_all(model.parameters())
        rng = np.random.default_rng(seed)
        losses = []
        for epoch in range(steps):
            total_loss = 0.0
            dataset.shuffle_with_seed(int(rng.integers(2 ** 63)))
            for input_array, target_array in dataset.batch(2).drop_last():
                result = model.forward(nk.from_ndarray(input_array))
                loss = nn.loss.mse_loss(result, nk.from_ndarray(target_array),
                                        nn.loss.Reduction.Mean)
                loss.forward()
                total_loss += loss.item()
                loss.backward(1.0)
                optimizer.step()
                optimizer.zero_grad()
            losses.append(total_loss)
            if verbose:
                print(f"Loss for epoch {epoch} : {total_loss} ")
        return losses


if __name__ == "__main__":
    main()
