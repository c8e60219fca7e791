"""Model tier of the port: the functional models (params-dict programs,
`transformer`, `bert`, `t5`, `vit`, `lora`, `resnet`) and the
define-by-run models of the layer kit (`MLP`, `MnistCNN`, `CharRNN`)."""

from . import bert, lora, resnet, t5, transformer, vit  # noqa: F401
from .cnn import MnistCNN  # noqa: F401
from .mlp import MLP  # noqa: F401
from .rnn import CharRNN  # noqa: F401

__all__ = ["transformer", "resnet", "vit", "MLP", "MnistCNN", "CharRNN"]
