"""The fused linear cross-entropy of the port (neuronika_tpu_torch/ops/
cross_entropy.py, K8-K10, and `loss_fn` with fused_ce="on") against the
JAX package on the CPU: the plain versions against JAX's Pallas kernels in
interpret mode (as tests/test_pallas.py runs them), in f32, in bf16 and on
a ragged shape; the "divisible" check; the slice (a tied GPT and an untied
llama head) against JAX's hidden states and fused kernels and against its
composite loss; two Adam steps with the fused loss against the composite;
JAX's gate; and, on the card, each CUDA kernel against its plain version.
Inputs come from numpy seeds; params from the JAX tree through
`params_from_jax`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.models import transformer as JT
from neuronika_tpu.ops.pallas import cross_entropy as JCE
from neuronika_tpu_torch._tree import tree_leaves, tree_map, tree_unflatten
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.ops import cross_entropy as CE
from tests.conftest import TOL
from tests.test_torch_train import (GRAD_TOL, LR, _adam_params_close,
                                    _batch, _port_grads, _tree_err)

# bf16: both sides sum exact bf16 products in f32 in another order, round
# p g to bf16 (a rounding may flip by one bf16 ulp where the f32 values
# differ in their last bits) and round dx and dW once: held in norm to one
# bf16 ulp (2^-8) of the result's norm, and each entry to two bf16 ulps of
# the largest entry
BF16_NORM_REL = 2 ** -8
BF16_ENTRY_ULPS = 2


def _case(N, D, V, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D), dtype=np.float32)
    w = (0.05 * rng.standard_normal((V, D))).astype(np.float32)
    t = rng.integers(0, V, size=N).astype(np.int32)
    return x, w, t


def _jax_run(x, w, t, dtype, *blocks):
    """JAX's fused loss (interpret mode) and its gradients in dtype."""
    def f(a, b):
        return JCE.fused_linear_cross_entropy(a, b, jnp.asarray(t), *blocks)

    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    loss, (dx, dw) = jax.value_and_grad(f, argnums=(0, 1))(xj, wj)
    return (float(loss), np.asarray(dx, np.float32),
            np.asarray(dw, np.float32))


def _port_run(x, w, t, dtype, *blocks):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = CE.fused_linear_cross_entropy(xt, wt, torch.from_numpy(t),
                                         *blocks)
    loss.backward()
    assert loss.dtype == torch.float32
    assert xt.grad.dtype == wt.grad.dtype == dtype
    return (float(loss.detach()), xt.grad.float().numpy(),
            wt.grad.float().numpy())


def _bf16_close(a, ref, what):
    """||a - ref|| <= BF16_NORM_REL ||ref||, every entry within
    BF16_ENTRY_ULPS bf16 ulps of max |ref|."""
    top = float(np.abs(ref).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = np.linalg.norm(a - ref)
    assert err <= BF16_NORM_REL * np.linalg.norm(ref), (what, err)
    assert np.abs(a - ref).max() <= BF16_ENTRY_ULPS * ulp, what


def test_plain_versions_match_jax_kernels_f32():
    """N 512, D 64, V 1024 with JAX's blocks 128 and 256: loss, dx, dW."""
    x, w, t = _case(512, 64, 1024)
    jl, jdx, jdw = _jax_run(x, w, t, jnp.float32, 128, 256, True)
    tl, tdx, tdw = _port_run(x, w, t, torch.float32, 128, 256, True)
    assert abs(tl - jl) <= TOL
    assert np.abs(tdx - jdx).max() <= TOL
    assert np.abs(tdw - jdw).max() <= TOL
    ref = CE.reference_linear_cross_entropy(torch.from_numpy(x),
                                            torch.from_numpy(w),
                                            torch.from_numpy(t))
    assert abs(tl - float(ref)) <= TOL


def test_plain_versions_match_jax_kernels_bf16():
    x, w, t = _case(512, 64, 1024, seed=1)
    jl, jdx, jdw = _jax_run(x, w, t, jnp.bfloat16, 128, 256, True)
    tl, tdx, tdw = _port_run(x, w, t, torch.bfloat16, 128, 256, True)
    # the loss is f32 on both sides, from the same bf16 operands
    assert abs(tl - jl) <= TOL
    _bf16_close(tdx, jdx, "dx")
    _bf16_close(tdw, jdw, "dw")


def test_ragged_shape_with_default_blocks_matches_jax():
    """N 300, V 1000: JAX's default blocks take the whole of each."""
    x, w, t = _case(300, 72, 1000, seed=2)
    jl, jdx, jdw = _jax_run(x, w, t, jnp.float32, None, 1024, True)
    tl, tdx, tdw = _port_run(x, w, t, torch.float32)
    assert abs(tl - jl) <= TOL
    assert np.abs(tdx - jdx).max() <= TOL
    assert np.abs(tdw - jdw).max() <= TOL


def test_blocks_that_do_not_divide_raise_as_in_jax():
    x, w, t = torch.zeros(100, 64), torch.zeros(1000, 64), torch.zeros(
        100, dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible"):
        JCE.fused_linear_cross_entropy(jnp.asarray(x.numpy()),
                                       jnp.asarray(w.numpy()),
                                       jnp.asarray(t.numpy()), 64, 256, True)
    with pytest.raises(ValueError, match="divisible"):
        CE.fused_linear_cross_entropy(x, w, t, 64, 256, True)


@pytest.mark.parametrize("call,err", [
    (lambda: CE.ce_fwd(torch.zeros(4, 8), torch.zeros(16, 9),
                       torch.zeros(4, dtype=torch.int32)), ValueError),
    (lambda: CE.ce_fwd(torch.zeros(4, 8), torch.zeros(16, 8),
                       torch.zeros(5, dtype=torch.int32)), ValueError),
    (lambda: CE.ce_fwd(torch.zeros(4, 8), torch.zeros(16, 8).bfloat16(),
                       torch.zeros(4, dtype=torch.int32)), TypeError),
    (lambda: CE.ce_fwd(torch.zeros(4, 8), torch.zeros(16, 8),
                       torch.zeros(4)), TypeError),
], ids=["width", "targets", "dtypes", "float-targets"])
def test_wrappers_refuse_bad_operands(call, err):
    with pytest.raises(err):
        call()


def test_targets_out_of_range_match_no_column():
    """As in the TPU kernels' masks: no target logit, no onehot."""
    x, w, t = _case(16, 8, 32, seed=3)
    t[:3] = (-1, 32, 1000)
    xt, wt, tt = (torch.from_numpy(a) for a in (x, w, t))
    loss, lse = CE.ce_fwd(xt, wt, tt)
    logits = xt @ wt.T
    assert torch.allclose(lse, torch.logsumexp(logits, -1), atol=TOL)
    assert torch.allclose(loss[:3], lse[:3], atol=0.0)
    g = torch.full((16,), 0.5)
    dx = CE.ce_dx(xt, wt, tt, lse, g)
    p = torch.softmax(logits, -1)
    assert torch.allclose(dx[:3], 0.5 * p[:3] @ wt, atol=TOL)


@pytest.mark.parametrize("kind,dtype,N,V,D,want", [
    ("dw", torch.bfloat16, 32768, 16384, 1536, "sm90"),    # phase 6's head
    ("dw", torch.bfloat16, 300, 1000, 72, "sm90"),         # one slice
    ("dw", torch.bfloat16, 777, 555, 1000, "sm90"),        # ragged slices
    ("dw", torch.bfloat16, 64, 130, 1544, "ce_grad"),      # 9 slices
    ("dw", torch.bfloat16, 64, 130, 33, "ce_grad"),        # D % 8
    ("dw", torch.float32, 32768, 16384, 1536, "ce_grad"),
    ("dx", torch.bfloat16, 32768, 16384, 1536, "sm90"),
    ("dx", torch.float32, 512, 1024, 64, "ce_grad"),
    ("dx", torch.bfloat16, 64, 130, 1544, "ce_grad"),      # 9 slices
    ("dx", torch.bfloat16, 64, 130, 33, "ce_grad"),        # D % 8
], ids=["head", "d72", "d1000", "d1544", "d33", "f32", "k9-bf16",
        "k9-f32", "k9-d1544", "k9-d33"])
def test_ce_grad_route_by_shape(kind, dtype, N, V, D, want):
    """bf16 K9 and K10 with D a multiple of 8 in at most 8 slices of 192
    on the Hopper kernel; f32, wider D and D not a multiple of 8 on the
    template."""
    assert CE.ce_grad_route(kind, dtype, D) == want


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 1536, "sm90"),     # phase 6's head
    (torch.bfloat16, 72, "sm90"),
    (torch.bfloat16, 4160, "sm90"),     # wider than K9/K10's cluster: K8
    (torch.bfloat16, 8, "sm90"),        # holds no D-wide accumulator
    (torch.bfloat16, 33, "ce_fwd"),     # D % 8: TMA's 16-byte rows
    (torch.bfloat16, 1540, "ce_fwd"),
    (torch.float32, 1536, "ce_fwd"),
    (torch.float32, 64, "ce_fwd"),
], ids=["head", "d72", "d4160", "d8", "d33", "d1540", "f32", "f32-d64"])
def test_ce_fwd_route_by_shape(dtype, D, want):
    """bf16 K8 with D a multiple of 8 on the Hopper kernel, at any D; f32
    and D not a multiple of 8 on the template."""
    assert CE.ce_fwd_route(dtype, D) == want


def _cu_constants(path):
    """The `constexpr int kName = value;` lines of a CUDA source."""
    import pathlib
    import re

    text = (pathlib.Path(CE.__file__).parent.parent / "csrc" / path
            ).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


PLAN_SHAPES = [
    (32768, 16384, 1536), (300, 1000, 72), (777, 555, 1000), (64, 130, 8),
    (129, 700, 1536), (1, 1, 192), (513, 129, 200), (4096, 257, 1528)]


def _plan_covers(kind, N, V, D):
    """The Hopper K9/K10's cut, as ce_grad_plan_sm90 mirrors it: the
    slices cover D's columns once and in order, one cluster of at most 8
    CTAs holds them, each accumulator at most 192 wide; the own blocks
    cover the own rows and the rounds of cs tiles the stream rows."""
    cu = _cu_constants("cross_entropy_sm90.cu")
    assert (cu["kOwn"], cu["kStream"], cu["kSlice"], cu["kMaxCluster"]) == (
        CE.SM90_OWN, CE.SM90_STREAM, CE.SM90_SLICE, CE.SM90_MAX_CLUSTER)
    own, stream = (N, V) if kind == "dx" else (V, N)
    cs, grid, slices, rounds = CE.ce_grad_plan_sm90(kind, N, V, D)
    assert grid[0] == cs == len(slices) <= CE.SM90_MAX_CLUSTER
    cols = [c for a, b in slices for c in range(a, b)]
    assert cols == list(range(D))
    assert all(0 < b - a <= CE.SM90_SLICE for a, b in slices)
    assert grid[1] * CE.SM90_OWN >= own > (grid[1] - 1) * CE.SM90_OWN
    tiles = -(-stream // CE.SM90_STREAM)
    assert rounds * cs >= tiles > (rounds - 1) * cs
    assert CE.ce_grad_route(kind, torch.bfloat16, D) == "sm90"


@pytest.mark.parametrize("N,V,D", PLAN_SHAPES)
def test_ce_dw_plan_sm90_covers_every_column_once(N, V, D):
    """K10 owns W blocks over V and streams x over N, mirrored from
    csrc/cross_entropy_sm90.cu's tile widths."""
    _plan_covers("dw", N, V, D)


@pytest.mark.parametrize("N,V,D", PLAN_SHAPES)
def test_ce_dx_plan_sm90_covers_every_column_once(N, V, D):
    """K9 owns x blocks over N and streams W over V, mirrored from
    csrc/cross_entropy_sm90.cu's tile widths."""
    _plan_covers("dx", N, V, D)


@pytest.mark.parametrize("N,V,D", PLAN_SHAPES + [(256, 520, 4160),
                                                 (300, 2300, 4160)])
def test_ce_fwd_plan_sm90_covers_every_vocab_tile_once(N, V, D):
    """K8 owns x blocks over N, a cluster's CTAs sharing one, and cuts the
    vocabulary into contiguous rank ranges of whole SM90_FWD_STREAM-row
    tiles, mirrored from csrc/cross_entropy_sm90.cu: every vocabulary row
    in exactly one rank's range, in rank order, none empty, at most a
    portable cluster of ranks; D does not enter the cut."""
    cu = _cu_constants("cross_entropy_sm90.cu")
    assert (cu["kOwn"], cu["kFwdStream"], cu["kMaxCluster"]) == (
        CE.SM90_OWN, CE.SM90_FWD_STREAM, CE.SM90_MAX_CLUSTER)
    cs, grid, ranges = CE.ce_fwd_plan_sm90(N, V, D)
    assert grid[0] == cs == len(ranges) <= CE.SM90_MAX_CLUSTER
    assert grid[1] * CE.SM90_OWN >= N > (grid[1] - 1) * CE.SM90_OWN
    rows = [v for a, b in ranges for v in range(a, b)]
    assert rows == list(range(V))
    assert all(b > a and a % CE.SM90_FWD_STREAM == 0 for a, b in ranges)
    tiles = -(-V // CE.SM90_FWD_STREAM)
    assert cs == min(CE.SM90_MAX_CLUSTER, tiles)
    assert CE.ce_fwd_plan_sm90(N, V, 8) == (cs, grid, ranges)
    assert CE.ce_fwd_route(torch.bfloat16, D) == "sm90"


def test_counters_do_not_move_on_the_cpu():
    def counts():
        return [(k.launches, k.sm90_launches) for k in CE.KERNELS]

    before = counts()
    x, w, t = (torch.from_numpy(a) for a in _case(64, 16, 128, seed=4))
    x, w = x.bfloat16(), w.bfloat16()
    _, lse = CE.ce_fwd(x, w, t)
    g = torch.full((64,), 1 / 64)
    CE.ce_dx(x, w, t, lse, g)
    CE.ce_dw(x, w, t, lse, g)
    assert counts() == before


def test_gpt_config_accepts_fused_ce_on():
    cfg = TT.GPTConfig(fused_ce="on")
    assert cfg.fused_ce == "on"


# the slice: a tied GPT (vocab 1024, L2, d128, hd 64, which the flash
# kernels take on the card) and an untied llama head; B2 S128 gives 256
# rows, so the gate fires
SLICE = dict(vocab_size=1024, n_layer=2, n_head=2, d_model=128, d_ff=256,
             max_seq=128)
HEADS = {"gpt-tied": (JT.GPTConfig, TT.GPTConfig),
         "llama-untied": (JT.llama_config, TT.llama_config)}


def _slice_cfgs(head, **kw):
    jfn, tfn = HEADS[head]
    base = dict(SLICE, **kw)
    return (jfn(dtype=jnp.float32, flash="off", **base),
            tfn(dtype=torch.float32, fused_ce="on", **base))


def _jax_fused_loss(params, toks, tgts, cfg):
    """JAX's fused branch of loss_fn, with the kernels in interpret mode
    (its loss_fn passes no interpret flag, which the CPU refuses)."""
    B, S = toks.shape
    x, _ = JT.hidden_states(params, toks, cfg, train=True)
    return JCE.fused_linear_cross_entropy(
        x.reshape(B * S, cfg.d_model),
        JT._head_w(params, cfg).astype(cfg.dtype), tgts.reshape(B * S),
        None, 1024, True)


@pytest.mark.parametrize("head", list(HEADS))
def test_fused_loss_fn_matches_jax(head):
    """The port's loss_fn with fused_ce="on" (plain K8-K10 on the CPU)
    against JAX's hidden states + fused kernels, and against JAX's
    composite loss_fn: loss and every gradient leaf."""
    jcfg, tcfg = _slice_cfgs(head)
    jp = JT.init_params(jax.random.key(0), jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp))
    assert ("lm_head" in tp) == (head == "llama-untied")
    toks, tgts = _batch(jcfg, B=2, S=128)
    jt, jg = jnp.asarray(toks), jnp.asarray(tgts)
    calls = []
    fused = CE.fused_linear_cross_entropy

    def spy(*a, **k):
        calls.append(a[0].shape)
        return fused(*a, **k)

    TT.fused_linear_cross_entropy, old = spy, TT.fused_linear_cross_entropy
    try:
        loss, grads = _port_grads(tp, tcfg, toks, tgts)
    finally:
        TT.fused_linear_cross_entropy = old
    assert calls == [(256, 128)]
    jloss, jgrads = jax.value_and_grad(_jax_fused_loss)(jp, jt, jg, jcfg)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert _tree_err(grads, jgrads) <= GRAD_TOL
    closs, cgrads = jax.value_and_grad(JT.loss_fn)(jp, jt, jg, jcfg,
                                                   train=True)
    assert abs(float(loss.detach()) - float(closs)) <= TOL
    assert _tree_err(grads, cgrads) <= GRAD_TOL


@pytest.mark.parametrize("head", list(HEADS))
def test_fused_eval_loss_runs_under_no_grad(head):
    _, tcfg = _slice_cfgs(head)
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    toks, tgts = (torch.from_numpy(a) for a in _batch(tcfg, B=2, S=128))
    with torch.no_grad():
        on = TT.loss_fn(tp, toks, tgts, tcfg)
        off = TT.loss_fn(tp, toks, tgts,
                         dataclasses.replace(tcfg, fused_ce="off"))
    assert abs(float(on) - float(off)) <= TOL


@pytest.mark.parametrize("accum", [1, 2], ids=["plain", "accum"])
def test_two_adam_steps_fused_against_composite(accum):
    """make_train_step with fused_ce="on" and "off" from the same params:
    the losses within TOL, the params within 2 lr a step (Adam's first
    step moves a noise-level gradient by +-lr). With accum_steps 2 each
    microbatch (B2 S128) still passes the gate."""
    _, tcfg = _slice_cfgs("gpt-tied")
    tp0 = TT.init_params(torch.Generator().manual_seed(1), tcfg, "cpu")
    runs = {}
    for mode in ("on", "off"):
        cfg = dataclasses.replace(tcfg, fused_ce=mode)
        tp = tree_map(torch.clone, tp0)
        opt = TT.opt_init(tp, cfg)
        step = TT.make_train_step(cfg, accum_steps=accum)
        losses = []
        for i in range(2):
            toks, tgts = _batch(cfg, B=2 * accum, S=128, seed=i)
            tp, opt, loss = step(tp, opt, torch.from_numpy(toks),
                                 torch.from_numpy(tgts), LR)
            losses.append(float(loss))
        runs[mode] = (losses, tp)
    assert np.abs(np.subtract(runs["on"][0], runs["off"][0])).max() <= TOL
    _adam_params_close(runs["on"][1], tree_map(torch.Tensor.numpy,
                                               runs["off"][1]), 2)


@pytest.mark.parametrize("B,S,V,fires", [
    (2, 128, 1024, True), (2, 100, 1024, False), (2, 128, 1000, False),
    (1, 128, 1024, False)], ids=["fires", "rows", "vocab", "rows-128"])
def test_gate_is_jaxs(B, S, V, fires):
    """The ops function is called only where rows % 256 == 0 and V % 1024
    == 0, as JAX's `_use_fused_ce`; "auto" never fuses."""
    cfg = TT.GPTConfig(vocab_size=V, n_layer=1, n_head=2, d_model=32,
                       d_ff=64, max_seq=128, dtype=torch.float32,
                       fused_ce="on")
    jcfg = JT.GPTConfig(vocab_size=V, fused_ce="on")
    assert JT._use_fused_ce(jcfg, B * S) == fires
    assert TT._use_fused_ce(cfg, B * S) == fires
    assert not TT._use_fused_ce(dataclasses.replace(cfg, fused_ce="auto"),
                                B * S)
    tp = TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.zeros(B, S, dtype=torch.long)
    calls = []
    old = TT.fused_linear_cross_entropy
    TT.fused_linear_cross_entropy = lambda *a: calls.append(1) or old(*a)
    try:
        TT.loss_fn(tp, toks, toks, cfg)
    finally:
        TT.fused_linear_cross_entropy = old
    assert calls == ([1] if fires else [])


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(cuda, N, D, V, dtype, seed=0):
    x, w, t = _case(N, D, V, seed)
    xt, wt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    tt = torch.from_numpy(t).to(cuda)
    g = torch.full((N,), 1.0 / N, device=cuda)
    return xt, wt, tt, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,D,V", [(512, 64, 1024), (300, 72, 1000),
                                   (256, 256, 1024), (129, 1536, 700),
                                   (64, 33, 130), (64, 4160, 130)])
def test_kernels_match_plain_on_gpu(cuda, N, D, V, dtype):
    """K8: loss and lse within 1e-5 of max(1, max |lse|). K9, K10: f32
    within 1e-5 of the largest entry; bf16 held as the CPU tests hold JAX
    (norm and entries). D 1536 runs K9/K10 as clusters of 3 slices; D 4160
    cuts more slices than a portable cluster holds (no cluster)."""
    x, w, t, g = _card_case(cuda, N, D, V, dtype)
    before = [k.launches for k in CE.KERNELS]
    loss, lse = CE.ce_fwd(x, w, t)
    dx = CE.ce_dx(x, w, t, lse, g)
    dw = CE.ce_dw(x, w, t, lse, g)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(CE.KERNELS, before)] == [1, 1, 1]
    rloss, rlse = CE.ce_fwd_reference(x, w, t)
    top = max(1.0, float(rlse.abs().max()))
    assert float((lse - rlse).abs().max()) <= TOL * top
    assert float((loss - rloss).abs().max()) <= TOL * top
    for out, ref in ((dx, CE.ce_dx_reference(x, w, t, rlse, g)),
                     (dw, CE.ce_dw_reference(x, w, t, rlse, g))):
        assert out.dtype == dtype and out.shape == ref.shape
        a, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
        if dtype == torch.float32:
            assert np.abs(a - r).max() <= TOL * np.abs(r).max()
        else:
            _bf16_close(a, r, "grad")


@pytest.mark.cuda
def test_fused_route_matches_composite_on_gpu(cuda):
    """f32 tied GPT, B2 S128: loss_fn with fused_ce on and off on the card,
    K8-K10 launched once each by the fused route."""
    _, tcfg = _slice_cfgs("gpt-tied", remat=False)
    tp = TT.init_params(torch.Generator(device=cuda).manual_seed(0), tcfg,
                        cuda)
    toks, tgts = (torch.from_numpy(a).to(cuda)
                  for a in _batch(tcfg, B=2, S=128))
    runs = {}
    for mode in ("on", "off"):
        before = [k.launches for k in CE.KERNELS]
        leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
        loss = TT.loss_fn(tree_unflatten(tp, leaves), toks, tgts,
                          dataclasses.replace(tcfg, fused_ce=mode),
                          train=True)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[mode] = (float(loss), grads,
                      [k.launches - b for k, b in zip(CE.KERNELS, before)])
    assert runs["on"][2] == [1, 1, 1] and runs["off"][2] == [0, 0, 0]
    assert abs(runs["on"][0] - runs["off"][0]) <= TOL
    assert max(float((a - b).abs().max())
               for a, b in zip(runs["on"][1], runs["off"][1])) <= GRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V", [(512, 64, 1024), (300, 72, 1000),
                                   (777, 1000, 555), (129, 1536, 700),
                                   (64, 40, 130), (1000, 1536, 300)])
def test_sm90_ce_dw_matches_plain_on_gpu(cuda, N, D, V):
    """The Hopper K10 (bf16): ragged N, V and D, one to eight slices, held
    as the CPU tests hold JAX (norm and entries)."""
    x, w, t, g = _card_case(cuda, N, D, V, torch.bfloat16, seed=5)
    assert CE.ce_grad_route("dw", torch.bfloat16, D) == "sm90"
    _, lse = CE.ce_fwd_reference(x, w, t)
    before = CE.ce_dw.launches, CE.ce_dw.sm90_launches
    dw = CE.ce_dw(x, w, t, lse, g)
    torch.cuda.synchronize()
    assert (CE.ce_dw.launches, CE.ce_dw.sm90_launches) == (before[0] + 1,
                                                           before[1] + 1)
    ref = CE.ce_dw_reference(x, w, t, lse, g)
    assert dw.dtype == torch.bfloat16 and dw.shape == ref.shape
    _bf16_close(dw.float().cpu().numpy(), ref.float().cpu().numpy(), "dw")


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V", [(512, 64, 1024), (300, 72, 1000),
                                   (777, 1000, 555), (129, 1536, 700),
                                   (64, 40, 130), (1000, 1536, 300)])
def test_sm90_ce_dx_matches_plain_on_gpu(cuda, N, D, V):
    """The Hopper K9 (bf16): ragged N, V (stream rows past V masked) and
    D, one to eight slices, held as the CPU tests hold JAX (norm and
    entries)."""
    x, w, t, g = _card_case(cuda, N, D, V, torch.bfloat16, seed=5)
    assert CE.ce_grad_route("dx", torch.bfloat16, D) == "sm90"
    _, lse = CE.ce_fwd_reference(x, w, t)
    before = CE.ce_dx.launches, CE.ce_dx.sm90_launches
    dx = CE.ce_dx(x, w, t, lse, g)
    torch.cuda.synchronize()
    assert (CE.ce_dx.launches, CE.ce_dx.sm90_launches) == (before[0] + 1,
                                                           before[1] + 1)
    ref = CE.ce_dx_reference(x, w, t, lse, g)
    assert dx.dtype == torch.bfloat16 and dx.shape == ref.shape
    _bf16_close(dx.float().cpu().numpy(), ref.float().cpu().numpy(), "dx")


@pytest.mark.cuda
def test_sm90_ce_dw_gives_the_same_bits_twice(cuda):
    x, w, t, g = _card_case(cuda, 4096, 1536, 2048, torch.bfloat16, seed=6)
    _, lse = CE.ce_fwd(x, w, t)
    a, b = CE.ce_dw(x, w, t, lse, g), CE.ce_dw(x, w, t, lse, g)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_sm90_ce_dx_gives_the_same_bits_twice(cuda):
    x, w, t, g = _card_case(cuda, 4096, 1536, 2048, torch.bfloat16, seed=6)
    _, lse = CE.ce_fwd(x, w, t)
    a, b = CE.ce_dx(x, w, t, lse, g), CE.ce_dx(x, w, t, lse, g)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,D", [
    ("dw", torch.bfloat16, 1544), ("dw", torch.float32, 1536),
    ("dx", torch.bfloat16, 1544)], ids=["dw-9-slices", "dw-f32", "dx"])
def test_ce_grads_route_to_the_template_on_gpu(cuda, kind, dtype, D):
    """f32 K10 and a D past one cluster (K9 or K10) run cross_entropy.cu."""
    N, V = 192, 300
    x, w, t, g = _card_case(cuda, N, D, V, dtype, seed=7)
    assert CE.ce_grad_route(kind, dtype, D) == "ce_grad"
    _, lse = CE.ce_fwd_reference(x, w, t)
    fn, ref_fn = ((CE.ce_dw, CE.ce_dw_reference) if kind == "dw"
                  else (CE.ce_dx, CE.ce_dx_reference))
    before = fn.launches, fn.sm90_launches
    out = fn(x, w, t, lse, g)
    torch.cuda.synchronize()
    assert (fn.launches, fn.sm90_launches) == (before[0] + 1, before[1])
    a, r = (v.float().cpu().numpy() for v in (out, ref_fn(x, w, t, lse, g)))
    if dtype == torch.float32:
        assert np.abs(a - r).max() <= TOL * np.abs(r).max()
    else:
        _bf16_close(a, r, kind)


# chip_smoke.py's CE_CASES (N, D, V): every one routes bf16 K8 to the
# Hopper kernel; and one vocabulary tile (a cluster of one CTA)
SM90_FWD_CASES = [(512, 64, 1024), (300, 72, 1000), (512, 256, 1024),
                  (256, 4160, 520), (777, 1000, 555), (1000, 1536, 300),
                  (64, 40, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V", SM90_FWD_CASES)
def test_sm90_ce_fwd_matches_plain_on_gpu(cuda, N, D, V):
    """The Hopper K8 (bf16): ragged N, V and D, one to eight cluster
    ranks; loss and lse within 1e-5 of max(1, max |lse|), and targets
    outside [0, V) matching no column."""
    x, w, t, _ = _card_case(cuda, N, D, V, torch.bfloat16, seed=9)
    t[:3] = torch.tensor([-1, V, 2 ** 30], dtype=t.dtype)
    assert CE.ce_fwd_route(torch.bfloat16, D) == "sm90"
    before = CE.ce_fwd.launches, CE.ce_fwd.sm90_launches
    loss, lse = CE.ce_fwd(x, w, t)
    torch.cuda.synchronize()
    assert (CE.ce_fwd.launches, CE.ce_fwd.sm90_launches) == (
        before[0] + 1, before[1] + 1)
    rloss, rlse = CE.ce_fwd_reference(x, w, t)
    top = max(1.0, float(rlse.abs().max()))
    assert loss.dtype == lse.dtype == torch.float32
    assert float((lse - rlse).abs().max()) <= TOL * top
    assert float((loss - rloss).abs().max()) <= TOL * top


@pytest.mark.cuda
def test_sm90_ce_fwd_gives_the_same_bits_twice(cuda):
    x, w, t, _ = _card_case(cuda, 4096, 1536, 16384, torch.bfloat16,
                            seed=6)
    a, b = CE.ce_fwd(x, w, t), CE.ce_fwd(x, w, t)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_ce_fwd_routes_to_the_template_on_gpu(cuda):
    """f32 K8 and bf16 K8 with D not a multiple of 8 run cross_entropy.cu."""
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 33)):
        x, w, t, _ = _card_case(cuda, 192, D, 300, dtype, seed=7)
        assert CE.ce_fwd_route(dtype, D) == "ce_fwd"
        before = CE.ce_fwd.launches, CE.ce_fwd.sm90_launches
        loss, lse = CE.ce_fwd(x, w, t)
        torch.cuda.synchronize()
        assert (CE.ce_fwd.launches, CE.ce_fwd.sm90_launches) == (
            before[0] + 1, before[1])
        rloss, rlse = CE.ce_fwd_reference(x, w, t)
        top = max(1.0, float(rlse.abs().max()))
        assert float((lse - rlse).abs().max()) <= TOL * top
        assert float((loss - rloss).abs().max()) <= TOL * top
