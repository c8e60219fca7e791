"""The port's top-level entry points (`neuronika_tpu_torch/entry.py`) against
the JAX package's (`__graft_entry__.py`) on the CPU.

`entry()`: the flagship (V512 L4 H4 d256 d_ff 1024 S128 bf16) with JAX's
params carried across (`params_from_jax`), on JAX's own zero tokens and
on uniform tokens. bf16 bound: the two packages round the same bf16 ops
in other places (XLA fuses elementwise chains), four layers deep, so each
logit is held within 2^-6 of the largest |JAX logit| (phase 3's bf16
bound on K1's output) and the logits in norm within 2^-6 of JAX's; they
read 2^-7.4 and 2^-6.8 apart on the CPU.

`dryrun_multichip(n, device="cpu")`: every section of JAX's dryrun on n
spawned gloo ranks, each printing its line (n = 4 and 8; ~8 s each)."""

import numpy as np
import pytest
import torch

import neuronika_tpu_torch as nk
from neuronika_tpu_torch.entry import FLAGSHIP, dryrun_multichip, entry
from neuronika_tpu_torch.models import transformer as T

BF16_REL = 2 ** -6
SECTIONS = ("dryrun_multichip ok: mesh", "dryrun fsdp ok:", "dryrun pp ok:",
            "dryrun pp-1f1b ok:", "dryrun packed-qkv flash ok:",
            "dryrun cp ring-attention ok:", "dryrun tp-serving ok:",
            "dryrun batcher-on-mesh ok:", "dryrun grouped-admission ok:",
            "dryrun define-by-run dp ok:")


@pytest.fixture(scope="module")
def jax_entry():
    import __graft_entry__ as G

    return G.entry()


@pytest.mark.parametrize("tokens", ["entry", "uniform"])
def test_entry_matches_jax_entry(jax_entry, tokens):
    import jax

    jfwd, (jparams, jtoks) = jax_entry
    old = nk.config.device
    nk.config.device = "cpu"
    try:
        fwd, (params, toks) = entry()
    finally:
        nk.config.device = old
    assert toks.shape == jtoks.shape and toks.dtype == torch.int32
    assert not toks.any() and not np.asarray(jtoks).any()
    shapes = jax.tree.map(lambda a: a.shape, jparams)
    assert T.param_shapes(T.GPTConfig(dtype=torch.bfloat16, **FLAGSHIP)) \
        .keys() == shapes.keys()
    if tokens == "uniform":
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, FLAGSHIP["vocab_size"], tuple(toks.shape)).astype(np.int32))
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams))
    got = fwd(params, toks).double().numpy()
    want = np.asarray(jfwd(jparams, toks.numpy())).astype(np.float64)
    assert got.shape == want.shape == (4, 128, FLAGSHIP["vocab_size"])
    assert np.isfinite(got).all()
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= BF16_REL * top
    assert np.linalg.norm(got - want) <= BF16_REL * np.linalg.norm(want)


def test_entry_runs_on_the_card_unless_asked():
    """entry() and dryrun_multichip() default to config.device ("cuda"):
    without a card they raise; nothing carries on on the CPU."""
    old = nk.config.device
    nk.config.device = "cuda"
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                entry()
            with pytest.raises(RuntimeError, match="cuda"):
                dryrun_multichip(4)
    finally:
        nk.config.device = old
    with pytest.raises(ValueError, match="even"):
        dryrun_multichip(3, device="cpu")


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_ranks(n, capsys):
    lines, launches = dryrun_multichip(n, device="cpu")
    printed = capsys.readouterr().out.splitlines()
    assert printed == lines
    assert lines[0] == f"dryrun_multichip: {n} ranks, gloo on the CPU"
    assert len(lines) == 1 + len(SECTIONS)
    for line, head in zip(lines[1:], SECTIONS):
        assert line.startswith(head), (line, head)
    assert "local heads 1" in lines[5]
    if n % 8 == 0:
        assert "ep=2" in lines[1] and "moe(E=4,ep-a2a)" in lines[1]
    assert f"dp={n} sharded leaves" in lines[-1]
    assert sum(launches.values()) == 0   # plain versions on the CPU
