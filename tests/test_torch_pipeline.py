"""Pipeline parallelism (neuronika_tpu_torch/parallel/pipeline.py, the
pipelined GPT train steps) and the pipeline's collectives against the JAX
package on the CPU, mirroring tests/test_parallel.py's pipeline tests.

Every rank case runs in ONE spawn of 4 gloo ranks (`parallel.mesh.spawn`,
a FileStore under tmp_path, 60 s a collective, the run terminated after
240 s), while JAX computes its references on conftest's virtual mesh (the
first 4 devices, the same mesh shape) from the same numpy-seeded inputs.
Each rank also runs every case on a virtual pipeline of the same stages
in its own process (`mesh=None`, `n_stages`), the form `chip_smoke.py`
runs on one card: it must give the ranks' results bit for bit, but for
the 1F1B losses with an aux term, whose sum over the stages crosses ranks
(1e-6). f32 against JAX within its own tests' bounds (1e-6 for the
forward and GPipe's gradients, 1e-5 for the rest). The ranks import this
module, so jax is imported only inside the functions that compute the
references."""

import concurrent.futures
import sys

import numpy as np
import pytest
import torch

from neuronika_tpu_torch import parallel as P
from neuronika_tpu_torch._tree import tree_map
from neuronika_tpu_torch.models import transformer as T
from tests.test_torch_parallel import (LR, PG_TIMEOUT, RUN_LIMIT, WORLD,
                                       _batch, _full, _leaves, _np_params)

FWD_TOL = 1e-6          # JAX's pipeline_forward and GPipe gradient tests
TOL = 1e-5              # JAX's 1F1B and pipelined-step tests
CROSS_TOL = 1e-6        # virtual against ranks where a sum crosses ranks
STAGES, D, M, MB = 4, 16, 6, 8
W_AUX = 0.05
STEP_CFG = dict(vocab_size=32, n_layer=4, n_head=2, d_model=32, d_ff=64,
                max_seq=16, remat=False)
# the pipelined steps' cases: (GPTConfig fields, schedule); JAX runs its
# composite where the port's flash="on" runs the flash ops' plain twins
STEP_CASES = {
    "gpipe": (dict(STEP_CFG, flash="off"), "gpipe"),
    "gpipe_flash": (dict(STEP_CFG, flash="on"), "gpipe"),
    "1f1b": (dict(STEP_CFG, flash="off"), "1f1b"),
    "1f1b_moe": (dict(STEP_CFG, flash="off", n_experts=4,
                      moe_aux_weight=W_AUX), "1f1b"),
}
N_MICRO = 4


def _tanh_inputs(stages=STAGES, d=D, m=M, mb=MB, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"w": (0.3 * rng.standard_normal((stages, d, d))).astype(f),
            "b": (0.1 * rng.standard_normal((stages, d))).astype(f),
            "head": (0.2 * rng.standard_normal((d, d))).astype(f),
            "micro": rng.standard_normal((m, mb, d)).astype(f),
            "tgt": rng.standard_normal((m, mb, d)).astype(f)}


def _block_inputs():
    rng = np.random.default_rng(3)
    return (_np_params(dict(STEP_CFG, flash="off")),
            rng.standard_normal((4, 2, 16, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def inputs():
    return {"tanh": _tanh_inputs(),
            "odd": _tanh_inputs(stages=2, d=8, m=3, mb=4, seed=1),
            "blocks": _block_inputs(),
            "steps": {c: _np_params(kw) for c, (kw, _) in STEP_CASES.items()},
            "batch": _batch(32, 8, 16)}


# --------------------------------------------------------------------------
# the rank side


def _tanh_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _tanh_stage_aux(p, x):
    return _tanh_stage(p, x), (x ** 2).mean()


def _tanh_stage_noaux(p, x):
    return torch.tanh(x @ p["w"]), torch.zeros(())


def _mse_head(y, t, lp):
    return ((y @ lp["head"] - t) ** 2).mean()


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return _full(t).detach().float().numpy()


def _stage_grads(g, stages, group):
    """The full (stages, ...) gradient from each rank's own stage (a
    leading axis of 1), or a virtual pipeline's stacked one."""
    if group is None:
        return g
    full = torch.zeros((stages,) + tuple(g.shape[1:]), dtype=g.dtype)
    full[torch.distributed.get_rank(group)] = g[0]
    torch.distributed.all_reduce(full, group=group)
    return full


def _forward_cases(mesh, inp):
    """pipeline_forward: the tanh stages, their GPipe gradients, and the
    transformer's blocks as stages."""
    from neuronika_tpu_torch.parallel.pipeline import pipeline_forward

    group = None if mesh is None else mesh.get_group("pp")
    a = inp["tanh"]
    out = {}
    params = {"w": _t(a["w"], True), "b": _t(a["b"], True)}
    pf = pipeline_forward(_tanh_stage, mesh, n_stages=STAGES)
    y = pf(params, _t(a["micro"]))
    out["forward"] = _np(y)
    loss = ((y - _t(a["tgt"])) ** 2).mean()
    grads = torch.autograd.grad(loss, [params["w"], params["b"]])
    # every rank's loss is the whole loss; a rank's gradient holds its own
    # stage's slice and zeros: the sum over the ranks assembles them
    for g in grads if group is not None else ():
        torch.distributed.all_reduce(g, group=group)
    out["gpipe_grads"] = {k: _np(g) for k, g in zip("wb", grads)}
    cfg = T.GPTConfig(dtype=torch.float32, **dict(STEP_CFG, flash="off"))
    bparams, bmicro = inp["blocks"]
    blocks = T.params_from_jax(bparams)["blocks"]
    pf = pipeline_forward(lambda blk, x: T._block(x, blk, cfg, False,
                                                  None)[0],
                          mesh, n_stages=STAGES)
    with torch.no_grad():
        out["blocks"] = _np(pf(blocks, _t(bmicro)))
    return out


def _onef1b_cases(mesh, mesh2, inp):
    """pipeline_train_1f1b: 4 stages with aux; 2 stages, 3 microbatches."""
    from neuronika_tpu_torch.parallel.pipeline import pipeline_train_1f1b

    out = {}
    for name, m, stage_fn, w_aux, key, stages in (
            ("aux", mesh, _tanh_stage_aux, W_AUX, "tanh", STAGES),
            ("odd", mesh2, _tanh_stage_noaux, 0.0, "odd", 2)):
        a = inp[key]
        group = None if m is None else m.get_group("pp")
        params = {"w": _t(a["w"])}
        if name == "aux":
            params["b"] = _t(a["b"])
        lp = {"head": _t(a["head"] if name == "aux"
                         else np.eye(a["w"].shape[1], dtype=np.float32))}
        run = pipeline_train_1f1b(stage_fn, _mse_head, m, aux_weight=w_aux,
                                  n_stages=stages)
        loss, gs, gl, dm = run(params, lp, _t(a["micro"]), _t(a["tgt"]))
        out[name] = {"loss": float(loss),
                     "gs": {k: _np(_stage_grads(v, stages, group))
                            for k, v in gs.items()},
                     "gl": _np(gl["head"]), "dm": _np(dm)}
    return out


def _step_cases(mesh, inp):
    """One step of make_pipelined_train_step (GPipe) and of the 1F1B step
    from each STEP_CASES's params: the loss and the staged params."""
    out = {}
    toks, tgts = (torch.from_numpy(a) for a in inp["batch"])
    for name, (kw, sched) in STEP_CASES.items():
        cfg = T.GPTConfig(dtype=torch.float32, **kw)
        make = (T.make_pipelined_train_step if sched == "gpipe"
                else T.make_pipelined_train_step_1f1b)
        step, reshape = make(mesh, cfg, N_MICRO, n_stages=STAGES)
        staged = reshape(T.params_from_jax(inp["steps"][name]))
        opt = T.opt_init(staged, cfg)
        staged, opt, loss = step(staged, opt, toks, tgts, LR)
        out[name] = {"loss": float(loss),
                     "params": tree_map(_np, staged),
                     "local": staged["blocks"]["qkv"].to_local().shape[0]
                     if mesh is not None else None}
    return out


def _collective_cases(rank):
    """send_next and all_to_all, forward and backward, on 4 ranks."""
    from neuronika_tpu_torch.parallel.collectives import (all_to_all,
                                                          send_next)

    mesh = P.make_mesh([("pp", WORLD)])
    group = mesh.get_group("pp")
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    y = send_next(x, group)
    (g,) = torch.autograd.grad((y * (rank + 1)).sum(), [x])
    a = (torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
         + 100 * rank).requires_grad_()
    b = all_to_all(a, 0, 1, group)
    (ga,) = torch.autograd.grad((b * b).sum(), [a])
    return {"send": y.detach().numpy(), "send_grad": g.numpy(),
            "a2a": b.detach().numpy(), "a2a_grad": ga.numpy()}


def _rank(rank, inp):
    import neuronika_tpu_torch as nk

    nk.config.device = "cpu"
    mesh = P.make_mesh([("pp", WORLD)])
    mesh2 = P.make_mesh([("dp", 2), ("pp", 2)])
    out = {"collectives": _collective_cases(rank)}
    for kind, m, m2 in (("ranks", mesh, mesh2), ("virtual", None, None)):
        out[kind] = {"forward": _forward_cases(m, inp),
                     "1f1b": _onef1b_cases(m, m2, inp),
                     "steps": _step_cases(m, inp)}
    out["jax_loaded"] = [m for m in ("jax", "neuronika_tpu")
                         if m in sys.modules]
    return out


# --------------------------------------------------------------------------
# the JAX side and the fixtures


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_ranks")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(P.mesh.spawn, _rank, WORLD, (inputs,),
                         init_file=str(tmp / "store"), timeout=PG_TIMEOUT,
                         limit=RUN_LIMIT)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_ref(launched, inputs):
    """JAX's pipeline results on the same inputs (computed while the ranks
    run)."""
    import jax
    import jax.numpy as jnp

    from neuronika_tpu import parallel as JP
    from neuronika_tpu.models import transformer as JT
    from neuronika_tpu.parallel.pipeline import (pipeline_forward,
                                                 pipeline_train_1f1b)

    mesh = JP.make_mesh([("pp", STAGES)], devices=jax.devices()[:STAGES])
    mesh2 = JP.make_mesh([("pp", 2)], devices=jax.devices()[:2])
    a = jax.tree.map(jnp.asarray, inputs["tanh"])
    params = {"w": a["w"], "b": a["b"]}

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    pf = pipeline_forward(stage, mesh)
    out = {"forward": np.asarray(pf(params, a["micro"]))}
    seq = a["micro"]
    for s in range(STAGES):
        seq = jnp.tanh(seq @ a["w"][s] + a["b"][s])
    out["sequential"] = np.asarray(seq)
    g = jax.grad(lambda p: ((pf(p, a["micro"]) - a["tgt"]) ** 2).mean())(
        params)
    out["gpipe_grads"] = jax.tree.map(np.asarray, g)

    jcfg = JT.GPTConfig(dtype=jnp.float32, **dict(STEP_CFG, flash="off"))
    bparams, bmicro = inputs["blocks"]
    blocks = jax.tree.map(jnp.asarray, bparams)["blocks"]
    out["blocks"] = np.asarray(pipeline_forward(
        lambda blk, x: JT._block(x, blk, jcfg, jax.random.key(0), False)[0],
        mesh)(blocks, jnp.asarray(bmicro)))

    def mse(y, t, lp):
        return ((y @ lp["head"] - t) ** 2).mean()

    def aux_stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"]), (x ** 2).mean()

    loss, gs, gl, dm = pipeline_train_1f1b(aux_stage, mse, mesh,
                                           aux_weight=W_AUX)(
        params, {"head": a["head"]}, a["micro"], a["tgt"])
    out["aux"] = {"loss": float(loss), "gs": jax.tree.map(np.asarray, gs),
                  "gl": np.asarray(gl["head"]), "dm": np.asarray(dm)}
    o = jax.tree.map(jnp.asarray, inputs["odd"])
    loss, gs, gl, dm = pipeline_train_1f1b(
        lambda p, x: (jnp.tanh(x @ p["w"]), jnp.zeros((), jnp.float32)),
        mse, mesh2)({"w": o["w"]}, {"head": jnp.eye(o["w"].shape[1])},
                    o["micro"], o["tgt"])
    out["odd"] = {"loss": float(loss), "gs": jax.tree.map(np.asarray, gs),
                  "gl": np.asarray(gl["head"]), "dm": np.asarray(dm)}

    toks, tgts = (jnp.asarray(x) for x in inputs["batch"])
    out["steps"] = {}
    for name, (kw, sched) in STEP_CASES.items():
        cfg = JT.GPTConfig(dtype=jnp.float32, **dict(kw, flash="off"))
        make = (JT.make_pipelined_train_step if sched == "gpipe"
                else JT.make_pipelined_train_step_1f1b)
        step, reshape = make(mesh, cfg, N_MICRO)
        staged = reshape(jax.tree.map(jnp.asarray, inputs["steps"][name]))
        staged, _, loss = step(staged, JT.adam_init(staged), toks, tgts,
                               jnp.float32(LR))
        out["steps"][name] = {"loss": float(loss),
                              "params": jax.tree.map(np.asarray, staged)}
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_ref):
    return launched.result()


def _close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err <= tol, err


# --------------------------------------------------------------------------
# the tests


def test_ranks_load_no_jax(ranks):
    assert all(r["jax_loaded"] == [] for r in ranks)


def test_send_next_is_ppermute_to_the_next_stage(ranks):
    """Rank r receives rank r - 1's tensor (rank 0 zeros); the backward
    brings rank r + 1's cotangent (the last rank zeros)."""
    for r, res in enumerate(ranks):
        c = res["collectives"]
        np.testing.assert_array_equal(c["send"], np.full((2, 3), float(r)))
        want = float(r + 2) if r < WORLD - 1 else 0.0
        np.testing.assert_array_equal(c["send_grad"], np.full((2, 3), want))


def test_all_to_all_is_tiled_and_its_own_transpose(ranks):
    """Rank j holds block j of every rank's rows, in rank order along the
    columns; the gradient of sum(b^2) is 2a, each row back home."""
    full = [np.arange(24, dtype=np.float32).reshape(8, 3) + 100 * r
            for r in range(WORLD)]
    for j, res in enumerate(ranks):
        c = res["collectives"]
        want = np.concatenate([f[2 * j:2 * j + 2] for f in full], 1)
        np.testing.assert_array_equal(c["a2a"], want)
        np.testing.assert_array_equal(c["a2a_grad"], 2 * full[j])


@pytest.mark.parametrize("kind", ["ranks", "virtual"])
def test_pipeline_forward_matches_sequential(ranks, jax_ref, kind):
    """GPipe over 4 stages equals the sequential stages and JAX's
    pipeline_forward; every rank holds the outputs."""
    for r in ranks:
        got = r[kind]["forward"]["forward"]
        _close(got, jax_ref["sequential"], FWD_TOL)
        _close(got, jax_ref["forward"], FWD_TOL)


@pytest.mark.parametrize("kind", ["ranks", "virtual"])
def test_pipeline_transformer_blocks(ranks, jax_ref, kind):
    """The GPT's blocks as 4 stages of one layer, against JAX's."""
    _close(ranks[0][kind]["forward"]["blocks"], jax_ref["blocks"], TOL)


@pytest.mark.parametrize("kind", ["ranks", "virtual"])
def test_pipeline_training_gradients_match_sequential(ranks, jax_ref, kind):
    """Differentiating through the GPipe schedule gives JAX's gradients
    (JAX's own test: the sequential stages' within 1e-6)."""
    g = ranks[0][kind]["forward"]["gpipe_grads"]
    for k in ("w", "b"):
        _close(g[k], jax_ref["gpipe_grads"][k], FWD_TOL)


@pytest.mark.parametrize("case", ["aux", "odd"])
@pytest.mark.parametrize("kind", ["ranks", "virtual"])
def test_1f1b_matches_jax(ranks, jax_ref, case, kind):
    """The 1F1B schedule's loss (with the aux term), stage gradients,
    loss-param gradients and microbatch cotangent: 4 stages, 6
    microbatches with aux; 2 stages, 3 microbatches (on a dp2 x pp2 mesh
    of the ranks)."""
    for r in ranks:
        got, want = r[kind]["1f1b"][case], jax_ref[case]
        assert abs(got["loss"] - want["loss"]) <= TOL
        for k, v in want["gs"].items():
            _close(got["gs"][k], v, TOL)
        _close(got["gl"], want["gl"], TOL)
        _close(got["dm"], want["dm"], TOL)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pipelined_step_matches_jax(ranks, jax_ref, case):
    """One step of make_pipelined_train_step (GPipe) or
    make_pipelined_train_step_1f1b on a ("pp", 4) mesh against JAX's on
    the same mesh shape: loss, blocks/qkv, wte and wpe; every rank holds
    one stage of the blocks and the same replicated leaves."""
    want = jax_ref["steps"][case]
    for r in ranks:
        got = r["ranks"]["steps"][case]
        assert abs(got["loss"] - want["loss"]) <= TOL
        assert got["local"] == 1
        for path in ("blocks/qkv", "wte", "wpe"):
            _close(_leaves(got["params"])["/" + path],
                   _leaves(want["params"])["/" + path], TOL)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_virtual_pipeline_repeats_the_ranks(ranks, case):
    """The virtual pipeline (every stage in one process, the form
    chip_smoke.py runs on one card) gives the ranks' steps: the params bit
    for bit (no gradient sums across ranks), the loss too but where the
    aux term sums over stages across ranks."""
    for r in ranks:
        a, b = r["ranks"]["steps"][case], r["virtual"]["steps"][case]
        for k, v in _leaves(a["params"]).items():
            np.testing.assert_array_equal(v, _leaves(b["params"])[k], k)
        if STEP_CASES[case][0].get("n_experts"):
            assert abs(a["loss"] - b["loss"]) <= CROSS_TOL
        else:
            assert a["loss"] == b["loss"]


@pytest.mark.parametrize("case", ["aux", "odd"])
def test_virtual_1f1b_repeats_the_ranks(ranks, case):
    r = ranks[0]
    a, b = r["ranks"]["1f1b"][case], r["virtual"]["1f1b"][case]
    for k in a["gs"]:
        np.testing.assert_array_equal(a["gs"][k], b["gs"][k])
    np.testing.assert_array_equal(a["gl"], b["gl"])
    np.testing.assert_array_equal(a["dm"], b["dm"])
    assert abs(a["loss"] - b["loss"]) <= CROSS_TOL


def test_virtual_forward_repeats_the_ranks(ranks):
    r = ranks[0]
    for k in ("forward", "blocks"):
        np.testing.assert_array_equal(r["ranks"]["forward"][k],
                                      r["virtual"]["forward"][k])


@pytest.mark.parametrize("make", [T.make_pipelined_train_step,
                                  T.make_pipelined_train_step_1f1b],
                         ids=["gpipe", "1f1b"])
def test_pipelined_steps_refuse_as_jax(make):
    """JAX's refusals: an untied head, a depth the stages do not divide;
    and a virtual pipeline needs its stage count."""
    cfg = T.GPTConfig(dtype=torch.float32, **STEP_CFG)
    with pytest.raises(ValueError, match="tied_head"):
        make(None, T.GPTConfig(dtype=torch.float32, tied_head=False,
                               **STEP_CFG), 2, n_stages=2)
    with pytest.raises(ValueError, match="divisible"):
        make(None, cfg, 2, n_stages=3)
    with pytest.raises(ValueError, match="n_stages"):
        make(None, cfg, 2)


def test_pipelined_step_rejects_a_batch_the_microbatches_do_not_split():
    cfg = T.GPTConfig(dtype=torch.float32, **STEP_CFG)
    step, reshape = T.make_pipelined_train_step(None, cfg, 3, n_stages=2)
    staged = reshape(T.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu"))
    toks = torch.zeros((4, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="n_micro 3"):
        step(staged, T.opt_init(staged, cfg), toks, toks, LR)


def test_virtual_gpipe_keeps_every_tick_and_1f1b_reruns_the_stage():
    """The flash op's calls on a virtual pipeline of 2 stages x 2 layers,
    3 microbatches: GPipe runs each (stage, microbatch) once forward (the
    live ticks only), 1F1B twice (the rerun at backward time); the same
    loss from both at moe_aux_weight 0."""
    cfg = T.GPTConfig(dtype=torch.float32, **dict(STEP_CFG, flash="on"))
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.randint(0, 32, (6, 16),
                         generator=torch.Generator().manual_seed(1))
    calls, real = [], T.flash_attention_qkv
    losses = {}
    try:
        T.flash_attention_qkv = lambda *a, **k: calls.append(1) or real(
            *a, **k)
        for name, make in (("gpipe", T.make_pipelined_train_step),
                           ("1f1b", T.make_pipelined_train_step_1f1b)):
            calls.clear()
            step, reshape = make(None, cfg, 3, n_stages=2)
            staged = reshape(tree_map(torch.clone, params))
            _, _, loss = step(staged, T.opt_init(staged, cfg), toks,
                              toks.roll(-1, 1), LR)
            losses[name] = (float(loss), len(calls))
    finally:
        T.flash_attention_qkv = real
    layers, micro = cfg.n_layer, 3
    assert losses["gpipe"][1] == layers * micro
    assert losses["1f1b"][1] == 2 * layers * micro
    assert abs(losses["gpipe"][0] - losses["1f1b"][0]) <= 1e-6
    ref = T.loss_fn(params, toks, toks.roll(-1, 1), cfg)
    assert abs(losses["gpipe"][0] - float(ref)) <= 1e-5
    assert all(np.isfinite(v) for v, _ in losses.values())
