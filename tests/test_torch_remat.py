"""The remat policies of the port's GPT (models/transformer.py:
`remat_policy` "full", "flash", "names", "dots" and "flash_dots", after
JAX's `_remat_policy`) on the CPU in f32: the loss and every gradient
under each policy against JAX's `loss_fn` under the same policy (the GPT-2
stack through the packed flash op, the llama stack with GQA and a window
through the split op; dropout 0, as JAX's masks come from its own PRNG)
and against the port's `remat=False` at dropout 0 and 0.2 (each layer's
mask is drawn from its seed, so a recomputed block draws it again); and
what each policy keeps: the flash forwards run once a layer under
"flash", "names" and "flash_dots" (twice under "full" and "dots", whose
backward recomputes them), "dots" keeps the 2-d matmuls and "names" one
copy of each tagged activation and nothing else."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.ops import flash_attention as FA
from tests.conftest import TOL
from tests.test_torch_train import (GRAD_TOL, _batch, _params, _port_grads,
                                    _tree_err)

POLICIES = TT.REMAT_POLICIES
SMALL = dict(vocab_size=96, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
             d_ff=128, max_seq=32)
STACKS = {"gpt": dict(n_kv_head=0), "llama-window": dict(window=12)}


def _cfgs(stack, **kw):
    fields = {**SMALL, **STACKS[stack], **kw}
    if stack == "gpt":
        return (JT.GPTConfig(dtype=jnp.float32, **fields),
                TT.GPTConfig(dtype=torch.float32, **fields))
    return (JT.llama_config(dtype=jnp.float32, **fields),
            TT.llama_config(dtype=torch.float32, **fields))


def test_policies_are_jaxs():
    """The same five names; an unknown one is refused."""
    assert set(POLICIES) == {"full", "flash", "names", "dots", "flash_dots"}
    assert TT._MATMUL_INPUT_NAMES == JT._MATMUL_INPUT_NAMES
    with pytest.raises(ValueError, match="remat_policy"):
        TT.GPTConfig(remat_policy="offload")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("stack", list(STACKS))
def test_grads_match_jax_under_the_same_policy(stack, policy):
    """JAX's loss_fn under `policy` (its composite attention) against the
    port's flash ops (their plain versions on the CPU) under `policy`."""
    jcfg, tcfg = _cfgs(stack, remat_policy=policy)
    jp, tp = _params(jcfg)
    toks, tgts = _batch(jcfg, S=32)
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg, train=True)
    loss, grads = _port_grads(tp, tcfg, toks, tgts)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert _tree_err(grads, jgrads) <= GRAD_TOL


def _grads(tp, tcfg, toks, tgts):
    """Loss and gradient leaves of one train-mode step, its dropout seeds
    drawn from a fixed generator."""
    from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten

    leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
    loss = TT.loss_fn(tree_unflatten(tp, leaves), torch.from_numpy(toks),
                      torch.from_numpy(tgts), tcfg, train=True,
                      generator=torch.Generator().manual_seed(7))
    loss.backward()
    return loss.detach(), [p.grad for p in leaves]


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("stack", list(STACKS))
def test_every_policy_gives_the_unrematerialised_gradients(stack, dropout):
    """Each policy's loss and gradients equal remat=False's bit for bit:
    the recompute redraws each layer's dropout mask from its seed."""
    jcfg, tcfg = _cfgs(stack, dropout=dropout)
    _, tp = _params(jcfg, seed=1)
    toks, tgts = _batch(jcfg, S=32, seed=1)
    ref = _grads(tp, dataclasses.replace(tcfg, remat=False), toks, tgts)
    for policy in POLICIES:
        got = _grads(tp, dataclasses.replace(tcfg, remat_policy=policy),
                     toks, tgts)
        assert torch.equal(got[0], ref[0]), policy
        assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1])), policy


class _OpCount(TorchDispatchMode):
    """Counts the ops that reach the dispatcher by packet."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket] += 1
        return func(*args, **(kwargs or {}))


def _counts(stack, policy):
    jcfg, tcfg = _cfgs(stack, remat_policy=policy)
    _, tp = _params(jcfg)
    toks, tgts = _batch(jcfg, S=32)
    with _OpCount() as c:
        _grads(tp, tcfg, toks, tgts)
    return c.n


@pytest.mark.parametrize("stack", list(STACKS))
def test_what_each_policy_keeps(stack):
    """Per layer, the backward's recompute reruns the flash forward under
    "full" and "dots" only; "dots" keeps the 2-d matmuls that "full"
    reruns (qkv, proj and the MLP's first, SwiGLU's gate a fourth: the
    recompute stops at the last op whose result the backward needs, so
    the MLP's output projection is rerun under no policy) and "names" a
    copy of each tagged activation (the tag op, run by the forward only:
    the recompute takes the kept copy) and no op that made it, as JAX's
    `save_only_these_names` keeps only the tagged values: its recompute
    reruns the layer norms and matmuls as "flash"'s does."""
    L = SMALL["n_layer"]
    fwd = (torch.ops.neuronika_tpu_torch.flash_fwd_qkv if stack == "gpt"
           else torch.ops.neuronika_tpu_torch.flash_fwd)
    n = {p: _counts(stack, p) for p in POLICIES}
    for p in POLICIES:
        kept = p in ("flash", "names", "flash_dots")
        assert n[p][fwd] == (L if kept else 2 * L), p
    mm = torch.ops.aten.mm
    dots = 4 if stack == "llama-window" else 3
    assert n["full"][mm] - n["dots"][mm] == dots * L
    assert n["flash"][mm] - n["flash_dots"][mm] == dots * L
    norm = (torch.ops.aten.native_layer_norm if stack == "gpt"
            else torch.ops.aten.rsqrt)
    assert n["full"][norm] == n["flash"][norm] == n["dots"][norm] \
        == n["names"][norm]
    assert n["names"][mm] == n["flash"][mm]
    # ln1_out, attn_qkv, ln2_out, ffn_pre; the split path's attn_q/k/v and
    # SwiGLU's ffn_gate besides
    tags = 8 if stack == "llama-window" else 4
    tag = torch.ops.neuronika_tpu_torch.checkpoint_tag
    assert n["names"][tag] == tags * L
    assert all(n[p][tag] == 0 for p in POLICIES if p != "names")


def test_fwd_ops_keep_a_u64_seed_and_their_fake_shapes():
    """The custom ops carry a dropout seed above 2^63 (as its two's
    complement) to the same mask, and report their outputs' shapes on
    the meta device."""
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 6 * 16), dtype=np.float32))
    seed = 2 ** 63 + 12345
    got = FA.flash_attention_qkv(qkv, 2, dropout=0.3, seed=seed)
    want, _ = FA.flash_attention_qkv_fwd_reference(qkv, 2, seed=seed,
                                                   rate=0.3)
    assert torch.equal(got, want)
    out, lse = FA.FWD_OPS[0](qkv.to("meta"), 2, 0, True, None, False, 0,
                             0.0)
    assert out.shape == (2, 16, 32) and lse.shape == (2, 2, 16)
    q = torch.zeros(2, 3, 5, 8, device="meta")
    out, lse = FA.FWD_OPS[1](q, q, q, True, None, 0, 0, 0.0)
    assert out.shape == q.shape and lse.shape == (2, 3, 5)
