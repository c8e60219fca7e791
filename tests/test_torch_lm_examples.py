"""The twins of the JAX package's `examples/text_pipeline.py` and
`examples/gpt_train.py` (neuronika_tpu_torch/examples/) on the CPU with
fewer steps: each runs from start to end and its loss falls; the text
pipeline's corpus and token ids equal those of the JAX example's
tokenizer, and gpt_train's text is the JAX example's."""

import importlib.util
import os

import numpy as np

from neuronika_tpu.data import BpeTokenizer as JBpe
from neuronika_tpu_torch.examples import gpt_train, text_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_text_pipeline_twin_runs_and_tokenizes_like_jax():
    jex = _jax_example("text_pipeline")
    assert text_pipeline.CORPUS == jex.CORPUS and text_pipeline.SEQ == jex.SEQ
    out = text_pipeline.main(device="cpu", steps=12, verbose=False)
    tok = JBpe.train([jex.CORPUS], vocab_size=512,
                     special_tokens=["<|end|>"])
    np.testing.assert_array_equal(out["ids"], tok.encode(jex.CORPUS))
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert np.isfinite(out["eval"]["loss"]) and out["eval"]["tokens"] > 0
    assert out["tokens"].shape == (1, len(tok.encode(text_pipeline.PROMPT))
                                   + 24)
    assert out["text"].startswith(text_pipeline.PROMPT)


def test_gpt_train_twin_runs():
    assert gpt_train.TEXT == _jax_example("gpt_train").TEXT
    out = gpt_train.main(device="cpu", steps=12, verbose=False)
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    P = len(gpt_train.PROMPT)
    assert out["greedy"].shape == out["sampled"].shape == (1, P + 40)
    assert out["beams"].shape == (1, 3, P + 40)
    assert (np.diff(out["scores"][0]) <= 1e-6).all()
