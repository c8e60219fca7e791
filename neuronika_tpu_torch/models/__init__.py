"""Model tier of the port: the functional models (params-dict programs,
`transformer`, `resnet`) and the define-by-run models of the layer kit
(`MLP`, `MnistCNN`, `CharRNN`)."""

from .cnn import MnistCNN  # noqa: F401
from .mlp import MLP  # noqa: F401
from .rnn import CharRNN  # noqa: F401

__all__ = ["MLP", "MnistCNN", "CharRNN"]
