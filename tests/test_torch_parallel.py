"""The port's scale-out tier (neuronika_tpu_torch/parallel/ and the sharded
GPT step) against the JAX package on the CPU, mirroring
tests/test_parallel.py and tests/test_trainer.py's mesh test.

The port runs one process a rank: every case runs in ONE spawn of 4 gloo
ranks (`parallel.mesh.spawn`, met through a FileStore under tmp_path; each
collective waits at most 60 s, the whole run is terminated after 240 s
and the tests then fail). Each rank builds its meshes from the same world.
JAX runs in this process, while the ranks run, on conftest's 8-device
virtual mesh (the first 4 devices), with the same mesh shape, from the
same numpy-seeded params (`params_from_jax`) and tokens. The rank
processes import this module to find their work, so jax is imported only
inside the functions that compute the references. f32; loss and params
within JAX's own 1e-4."""

import concurrent.futures
import dataclasses
import sys

import numpy as np
import pytest
import torch

from neuronika_tpu_torch import parallel as P
from neuronika_tpu_torch._tree import tree_map
from neuronika_tpu_torch.models import transformer as T

WORLD = 4
PG_TIMEOUT = 60.0         # s a collective may wait
RUN_LIMIT = 240.0         # s the spawned run may take
TOL = 1e-4
LR = 1e-3

TINY = dict(vocab_size=32, n_layer=2, n_head=2, d_model=32, d_ff=64,
            max_seq=16)
# test_parallel.py's expert-parallel config: capacity 8.0 drops no token,
# so the ep dispatch must give the dense dispatch's results
MOE = dict(TINY, flash="off", n_experts=4, moe_impl="ep", moe_capacity=8.0,
           moe_aux_weight=0.01)
# the gate scaled as JAX's test scales it, so that no f32 reduction order
# flips an argmax
GATE_SCALE = 30.0
# (mesh axes, GPTConfig fields, make_sharded_train_step keywords, batch B,
# S): test_parallel.py's cases at 4 ranks
STEPS = {
    "dp2tp2": ([("dp", 2), ("tp", 2)], TINY, {}, 8, 16),
    "flash": ([("dp", 2), ("tp", 2)],
              dict(TINY, n_head=4, max_seq=128, flash="on", remat=True,
                   flash_block=128), {}, 8, 128),
    "seq_parallel": ([("dp", 2), ("tp", 2)],
                     dict(TINY, flash="off", seq_parallel=True), {}, 8, 16),
    "packed": ([("dp", 2), ("tp", 2)],
               dict(vocab_size=32, n_layer=2, n_head=4, d_model=512,
                    d_ff=256, max_seq=128, flash="on", remat=False,
                    flash_block=128, flash_bwd="fused"), {}, 4, 128),
    "rope": ([("dp", 2), ("tp", 2)],
             dict(TINY, n_head=4, flash="off", pos_emb="rope"), {}, 8, 16),
    # tp splits the one kv group: the split layout gathers qkv over tp
    "gqa_window": ([("dp", 2), ("tp", 2)],
                   dict(TINY, n_head=4, n_kv_head=1, pos_emb="rope",
                        window=5), {}, 8, 16),
    "fsdp": ([("dp", 4)], TINY, dict(fsdp=True, fsdp_min_size=0), 8, 16),
    "fsdp_tp": ([("dp", 2), ("tp", 2)], TINY,
                dict(fsdp=True, fsdp_min_size=0), 8, 16),
    # expert parallelism (test_parallel.py's ep test at 4 ranks): the
    # all-to-all dispatch at a capacity that drops no token, with sequence
    # parallelism over tp (JAX's multi-device run pairs them) and over dp;
    # and the sort dispatch on an ep mesh (every expert gathered)
    "tp2ep2_sp": ([("tp", 2), ("ep", 2)], dict(MOE, seq_parallel=True), {},
                  4, 16),
    "dp2ep2": ([("dp", 2), ("ep", 2)], MOE, {}, 4, 16),
    "dp2ep2_sort": ([("dp", 2), ("ep", 2)], dict(MOE, moe_impl="sort"), {},
                    4, 16),
}
# JAX's sharded step is run for these (the rest: its unsharded step), on
# the same mesh shape (JAX's sharded step splits the batch over a dp axis:
# one of size 1 where the port's mesh has none)
JAX_SHARDED = ("dp2tp2", "fsdp", "tp2ep2_sp", "dp2ep2")
JAX_MESH = {"tp2ep2_sp": [("dp", 1), ("tp", 2), ("ep", 2)]}


def _np_params(cfg_kw, seed=0):
    """A params tree of the JAX structure (the port's `param_shapes`),
    drawn with numpy: N(0, 0.02) matrices, unit scales, small biases; an
    MoE gate GATE_SCALE x that."""
    rng = np.random.default_rng(seed)

    def draw(path, t):
        if path.endswith("scale"):
            return np.ones(t.shape, np.float32)
        s = 0.01 if path.endswith(("_b", "bias")) else 0.02
        return (s * rng.standard_normal(t.shape)).astype(np.float32)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        return draw(path, tree)

    params = walk(T.param_shapes(T.GPTConfig(**cfg_kw)))
    if "gate" in params["blocks"]:
        params["blocks"]["gate"] *= GATE_SCALE
    return params


def _batch(vocab, B, S, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _numpy_tree(tree):
    return tree_map(lambda t: _full(t).detach().float().numpy(), tree)


# --------------------------------------------------------------------------
# the rank side: one function a job, all run by `_rank`


def _job_steps(rank, params, batches):
    """Each STEPS case: one sharded step from the given params; the loss
    of every rank, the updated params gathered, and layout facts."""
    out = {}
    for name, (axes, kw, step_kw, B, S) in STEPS.items():
        cfg = T.GPTConfig(dtype=torch.float32, **kw)
        mesh = P.make_mesh(axes)
        calls = []
        if name == "packed":           # which packed op ran, at what shape
            real = T.flash_attention_qkv

            def spy(qkv, n_head, *a, **k):
                calls.append((tuple(qkv.shape), n_head))
                return real(qkv, n_head, *a, **k)

            T.flash_attention_qkv = spy
        try:
            p = T.params_from_jax(params[name])
            toks, tgts = (torch.from_numpy(a) for a in batches[name])
            step = T.make_sharded_train_step(mesh, cfg, **step_kw)
            p, opt, loss = step(p, T.opt_init(p, cfg), toks, tgts, LR)
        finally:
            if name == "packed":
                T.flash_attention_qkv = real
        qkv = p["blocks"]["qkv"]
        out[name] = {
            "loss": float(loss), "params": _numpy_tree(p),
            "m": _numpy_tree(opt["m"]), "calls": calls,
            "qkv_local": qkv.to_local().numel(),
            "qkv_full": qkv.numel(),
            "m_placements": str(opt["m"]["blocks"]["qkv"].placements),
            "p_placements": str(qkv.placements),
            "loss_type": type(loss).__name__,
        }
    return out


def _job_meshes(rank):
    """make_mesh factorizations, make_hybrid_mesh, distributed_init,
    shard_batch and make_global_batch."""
    res = {"dp": P.make_mesh().mesh_dim_names,
           "dp_shape": tuple(P.make_mesh().shape),
           "dp_tp": tuple(P.make_mesh([("dp", 2), ("tp", 2)]).shape),
           "inferred": tuple(P.make_mesh([("dp", -1), ("tp", 2)]).shape)}
    for name, call in (
            ("bad", lambda: P.make_mesh([("dp", 3), ("tp", 2)])),
            ("hybrid_bad", lambda: P.make_hybrid_mesh([("dp", 3),
                                                       ("tp", 2)]))):
        try:
            call()
            res[name] = "no error"
        except ValueError as e:
            res[name] = f"ValueError: {e}"
    hybrid = P.make_hybrid_mesh([("dp", 2), ("tp", 2)])
    res["hybrid"] = (hybrid.mesh_dim_names, tuple(hybrid.shape))
    res["distributed_init"] = P.distributed_init()
    mesh = P.make_mesh()
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    arr = P.shard_batch(x, mesh)
    res["shard_batch"] = (str(arr.placements), tuple(arr.to_local().shape),
                          arr.full_tensor().numpy())
    mesh2 = P.make_mesh([("dp", 2), ("tp", 2)])
    dp = mesh2.get_local_rank("dp")
    g = P.make_global_batch(x[4 * dp:4 * dp + 4], mesh2)
    ref = P.shard_batch(x, mesh2)
    res["global_batch"] = (tuple(g.shape), g.placements == ref.placements,
                           g.full_tensor().numpy())
    sh = T.fsdp_param_shardings(mesh2, T.GPTConfig(**TINY), min_size=0)
    big = T.fsdp_param_shardings(mesh2, T.GPTConfig(**TINY))
    moe = T.fsdp_param_shardings(mesh2, T.GPTConfig(**TINY, n_experts=4),
                                 min_size=0)["blocks"]["fc_in"].spec
    ep = T.param_shardings(P.make_mesh([("dp", 2), ("ep", 2)]),
                           T.GPTConfig(**TINY, n_experts=4))["blocks"]
    res["ep_specs"] = {k: ep[k].spec for k in ("gate", "fc_in", "fc_in_b",
                                                 "fc_out", "fc_out_b")}
    llama = T.fsdp_param_shardings(
        mesh2, T.llama_config(**dict(TINY, d_ff=48)), min_size=0)
    res["fsdp_specs"] = {
        "wte": sh["wte"].spec, "qkv": sh["blocks"]["qkv"].spec,
        "fc_out": sh["blocks"]["fc_out"].spec,
        "ln1_big": big["blocks"]["ln1"]["scale"].spec,
        "moe_fc_in": moe,
        "lm_head": llama["lm_head"].spec,
        "fc_gate": llama["blocks"]["fc_gate"].spec}
    return res


def _job_data_parallel(rank):
    """DataParallel's step against the same step on one device."""
    mesh = P.make_mesh()
    rng = np.random.default_rng(0)
    X = rng.standard_normal((8, 4)).astype(np.float32)
    Y = rng.standard_normal((8, 4)).astype(np.float32)

    def step(w, x, y):
        w = w.detach().requires_grad_()
        loss = ((x @ w - y) ** 2).mean()
        g, = torch.autograd.grad(loss, w)
        return w.detach() - 0.1 * g, loss.detach()

    w_dp, loss_dp = P.DataParallel(step, mesh)(
        torch.ones(4, 4), X, Y)
    w_ref, loss_ref = step(torch.ones(4, 4), torch.from_numpy(X),
                           torch.from_numpy(Y))
    return {"w": (_full(w_dp).numpy(), w_ref.numpy()),
            "loss": (float(_full(loss_dp)), float(loss_ref))}


def _job_trainer(rank, directory):
    """Trainer(mesh=) on a fixed batch for 6 steps (JAX's
    test_sharded_trainer_on_mesh), with and without fsdp; the fsdp run
    checkpointed at step 3 and resumed by a new Trainer, whose next
    steps must repeat the first run's."""
    from neuronika_tpu_torch.train import Trainer

    out = {}
    toks = np.tile(np.arange(16, dtype=np.int32), (8, 1))
    tgts = np.roll(toks, -1, axis=1)

    def trainer(fsdp, **kw):
        cfg = T.GPTConfig(vocab_size=64, n_layer=2, n_head=4, d_model=64,
                          d_ff=128, max_seq=48, dtype=torch.float32)
        return Trainer(cfg, generator=torch.Generator().manual_seed(0),
                       lr=1e-2, mesh=P.make_mesh([("dp", 2), ("tp", 2)]),
                       fsdp=fsdp, **kw)

    for fsdp in (False, True):
        kw = dict(checkpoint_dir=directory) if fsdp else {}
        tr = trainer(fsdp, **kw)
        losses = []
        for i in range(6):
            losses.append(float(tr.train_step(toks, tgts)))
            if fsdp and i == 2:
                tr.save()
        out[fsdp] = losses
        out[f"eval-{fsdp}"] = tr.evaluate([(toks, tgts)])["loss"]
    again = trainer(True, checkpoint_dir=directory)
    out["resumed_at"] = again.resume()
    out["resumed"] = [float(again.train_step(toks, tgts)) for _ in range(3)]
    return out


def _job_checkpoint(rank, directory):
    """A sharded leaf saved and restored straight into its placement."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from neuronika_tpu_torch.utils.checkpoint import Checkpointer

    mesh = P.make_mesh([("dp", 2), ("tp", 2)])
    x = distribute_tensor(torch.arange(64.0).reshape(8, 8), mesh,
                          [Shard(0), Shard(1)])
    like = {"x": distribute_tensor(torch.zeros(8, 8), mesh,
                                   [Shard(1), Replicate()])}
    with Checkpointer(directory, async_save=False) as ck:
        ck.save(1, {"x": x})
        ck.wait()
        out = ck.restore(like=like)
    return {"placements": str(out["x"].placements),
            "want": str(like["x"].placements),
            "local": out["x"].to_local().numpy(),
            "full": out["x"].full_tensor().numpy(),
            "saved": x.full_tensor().numpy()}


def _job_ep_overflow(rank):
    """test_parallel.py's ep overflow test at 4 ranks (dp2 x ep2, capacity
    1.0, so tokens drop): six steps on one batch, each rank's losses."""
    cfg = T.GPTConfig(dtype=torch.float32, **dict(MOE, n_layer=1,
                                                  moe_capacity=1.0))
    params = T.params_from_jax(_np_params(dict(MOE, n_layer=1)))
    toks, tgts = (torch.from_numpy(a) for a in _batch(32, 4, 16))
    step = T.make_sharded_train_step(P.make_mesh([("dp", 2), ("ep", 2)]),
                                     cfg)
    opt, losses = T.opt_init(params, cfg), []
    for _ in range(6):
        params, opt, loss = step(params, opt, toks, tgts, 5e-3)
        losses.append(float(loss))
    return losses


def _job_accepted(rank):
    """What the sharded tier refused before experts and pipelines were
    ported: a pp axis (through the pipelined step, on a dp2 x pp2 mesh)
    and experts on a mesh without an ep axis (the dense dispatch on dp4,
    against the unsharded step)."""
    cfg = T.GPTConfig(dtype=torch.float32, **dict(TINY, flash="off"))
    toks, tgts = (torch.from_numpy(a) for a in _batch(32, 4, 16))
    step, reshape = T.make_pipelined_train_step(
        P.make_mesh([("dp", 2), ("pp", 2)]), cfg, 2)
    staged = reshape(T.params_from_jax(_np_params(TINY)))
    _, _, pp_loss = step(staged, T.opt_init(staged, cfg), toks, tgts, LR)
    ref_loss = T.loss_fn(T.params_from_jax(_np_params(TINY)), toks, tgts,
                         cfg)
    moe = T.GPTConfig(dtype=torch.float32, **dict(MOE, moe_impl="dense"))
    params = T.params_from_jax(_np_params(MOE))
    _, _, loss = T.make_sharded_train_step(P.make_mesh([("dp", 4)]), moe)(
        params, T.opt_init(params, moe), toks, tgts, LR)
    params = T.params_from_jax(_np_params(MOE))
    _, _, dense = T.make_train_step(moe)(params, T.opt_init(params, moe),
                                         toks, tgts, LR)
    from neuronika_tpu_torch.train import Trainer

    tr = Trainer(T.GPTConfig(dtype=torch.float32, **MOE),
                 generator=torch.Generator().manual_seed(0), lr=1e-2,
                 mesh=P.make_mesh([("dp", 2), ("ep", 2)]))
    trainer = [float(tr.train_step(toks, tgts)) for _ in range(4)]
    return {"pp": (float(pp_loss), float(ref_loss)),
            "experts": (float(loss), float(dense)),
            "trainer_ep": (trainer, str(tr.params["blocks"]["fc_in"]
                                        .placements))}


def _rank(rank, jobs):
    import neuronika_tpu_torch as nk

    nk.config.device = "cpu"
    fns = {"steps": _job_steps, "meshes": _job_meshes,
           "data_parallel": _job_data_parallel, "trainer": _job_trainer,
           "checkpoint": _job_checkpoint, "ep_overflow": _job_ep_overflow,
           "accepted": _job_accepted}
    out = {name: fns[name](rank, *args) for name, args in jobs}
    out["jax_loaded"] = [m for m in ("jax", "neuronika_tpu")
                         if m in sys.modules]
    return out


# --------------------------------------------------------------------------
# the JAX side and the fixtures


@pytest.fixture(scope="module")
def inputs():
    params = {name: _np_params(kw) for name, (_, kw, *_r) in STEPS.items()}
    batches = {name: _batch(kw["vocab_size"], B, S)
               for name, (_, kw, _s, B, S) in STEPS.items()}
    return params, batches


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    """The spawned run, started in a thread so that JAX computes the
    references meanwhile."""
    tmp = tmp_path_factory.mktemp("ranks")
    jobs = [("steps", inputs), ("meshes", ()), ("data_parallel", ()),
            ("trainer", (str(tmp / "trainer"),)),
            ("checkpoint", (str(tmp / "ck"),)), ("ep_overflow", ()),
            ("accepted", ())]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(P.mesh.spawn, _rank, WORLD, (jobs,),
                         init_file=str(tmp / "store"), timeout=PG_TIMEOUT,
                         limit=RUN_LIMIT)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(launched, jax_steps):
    """The ranks' results: a list, one dict a rank."""
    return launched.result()


@pytest.fixture(scope="module")
def jax_steps(launched, inputs):
    """{case: {"unsharded": (loss, params, Adam's m), "sharded": ...}}
    from JAX."""
    import jax
    import jax.numpy as jnp

    from neuronika_tpu import parallel as JP
    from neuronika_tpu.models import transformer as JT

    params, batches = inputs
    out, unsharded = {}, {}
    for name, (axes, kw, step_kw, B, S) in STEPS.items():
        # the port's CPU flash ops are plain versions; JAX's composite is
        # the same math without interpret-mode kernels. With experts the
        # unsharded reference is the dense dispatch (every token kept)
        jcfg = JT.GPTConfig(dtype=jnp.float32, **dict(
            kw, flash="off", seq_parallel=False,
            **({"moe_impl": "dense"} if kw.get("n_experts") else {})))
        toks, tgts = (jnp.asarray(a) for a in batches[name])
        p0 = jax.tree.map(jnp.asarray, params[name])

        def run(step):
            p, opt, loss = step(jax.tree.map(jnp.copy, p0),
                                JT.adam_init(p0), toks, tgts,
                                jnp.float32(LR), jax.random.key(2))
            return (float(loss), jax.tree.map(np.asarray, p),
                    jax.tree.map(np.asarray, opt["m"]))

        # cases of one config share params and batch, so one unsharded run
        key = (repr(jcfg), B, S)
        if key not in unsharded:
            unsharded[key] = run(JT.make_train_step(jcfg))
        out[name] = {"unsharded": unsharded[key]}
        if name in JAX_SHARDED:
            mesh = JP.make_mesh(JAX_MESH.get(name, axes),
                                devices=jax.devices()[:WORLD])
            scfg = JT.GPTConfig(dtype=jnp.float32, **dict(kw, flash="off"))
            out[name]["sharded"] = run(JT.make_sharded_train_step(
                mesh, scfg, **step_kw))
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _params_close(port, ref):
    """Adam's first step moves a param by about LR * g / |g|, so where a
    gradient is at rounding-noise size the two sides may move it apart
    (test_torch_train.py's `_adam_params_close`; the port's unsharded step
    shows the same few entries against JAX). So: every param within 2 LR,
    and all but 1e-4 of them within TOL. The qkv bias is left out of the
    count: the k part of its gradient is analytically zero (softmax
    ignores a shift of a whole score row)."""
    pl, rl = _leaves(port), _leaves(ref)
    assert pl.keys() == rl.keys()
    d = {k: np.abs(pl[k] - np.asarray(rl[k], np.float32)).ravel()
         for k in pl}
    assert max(float(v.max()) for v in d.values()) <= 2 * LR
    counted = np.concatenate([v for k, v in d.items()
                              if not k.endswith("qkv_b")])
    assert (counted > TOL).mean() <= 1e-4, (counted > TOL).sum()


def _moments_close(port, ref):
    """Adam's first moment after one step is 0.1 g, the gradient's size
    that the params do not show (the first update is LR * sign(g)): each
    leaf within TOL of the leaf's largest |m|."""
    pl, rl = _leaves(port), _leaves(ref)
    assert pl.keys() == rl.keys()
    for k in pl:
        r = np.asarray(rl[k], np.float32)
        bound = TOL * max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(pl[k] - r).max()) <= bound, k


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_matches_jax(ranks, jax_steps, name):
    """Loss (the same on every rank), updated params and Adam's first
    moment of the port's sharded step against JAX's unsharded step (with
    experts its dense dispatch, and fc_in and the gate entry by entry
    within TOL), and for the JAX_SHARDED cases also against JAX's sharded
    step on the same mesh shape."""
    port = [r["steps"][name] for r in ranks]
    assert len({p["loss"] for p in port}) == 1
    assert port[0]["loss_type"] == "Tensor"
    for key, (jloss, jparams, jm) in jax_steps[name].items():
        assert abs(port[0]["loss"] - jloss) <= TOL, key
        _params_close(port[0]["params"], jparams)
        _moments_close(port[0]["m"], jm)
        if "gate" in jparams["blocks"]:     # test_parallel.py's ep checks
            for leaf in ("fc_in", "gate"):
                err = np.abs(port[0]["params"]["blocks"][leaf]
                             - np.asarray(jparams["blocks"][leaf])).max()
                assert err <= TOL, (key, leaf, err)


def test_ranks_load_no_jax(ranks):
    """The ranks import this module to find their work: neither jax nor
    the JAX package may come with it."""
    assert all(r["jax_loaded"] == [] for r in ranks)


def test_packed_kernel_runs_per_tp_shard(ranks):
    """hd 128, tp | KV: the packed op runs on each rank's whole kv groups:
    local batch 4/2, local heads 4/2, local packed width (2 + 2*2)*128
    (JAX's shard_map'd kernel sees the same)."""
    calls = ranks[0]["steps"]["packed"]["calls"]
    assert calls and all(c == ((2, 128, 768), 2) for c in calls), calls


def test_fsdp_layout_stores_a_shard_per_rank(ranks):
    """ZeRO-3: the local shard of qkv (split over tp and dp) times dp x tp
    is the full leaf; the Adam moments come back in the params' layout."""
    for name, split in (("fsdp", 4), ("fsdp_tp", 4), ("dp2tp2", 2)):
        r = ranks[0]["steps"][name]
        assert r["qkv_local"] * split == r["qkv_full"], name
        assert r["m_placements"] == r["p_placements"], name
    assert "Shard" in ranks[0]["steps"]["fsdp"]["m_placements"]


def test_fsdp_param_shardings_widen_the_tp_layout(ranks):
    sp = ranks[0]["meshes"]["fsdp_specs"]
    assert "dp" in sp["wte"] and "tp" in sp["wte"]
    assert "dp" in sp["qkv"] and "dp" in sp["fc_out"]
    assert "dp" not in sp["ln1_big"]          # under the default min_size
    # the experts' tp layout (no ep axis on this mesh) widened too
    assert "dp" in sp["moe_fc_in"] and "tp" in sp["moe_fc_in"]
    assert "dp" in sp["lm_head"] and "dp" in sp["fc_gate"]


def test_param_shardings_split_the_experts_over_ep(ranks):
    """JAX's ep layouts: the gate replicated, the expert axis over ep."""
    sp = ranks[0]["meshes"]["ep_specs"]
    assert all(a is None for a in sp["gate"])
    for k in ("fc_in", "fc_in_b", "fc_out", "fc_out_b"):
        assert sp[k][:2] == (None, "ep"), (k, sp[k])


def test_ep_overflow_trains(ranks):
    """Tokens dropped (capacity 1.0, counted per rank): the ep step stays
    finite and its loss falls over six steps, the same on every rank."""
    losses = ranks[0]["ep_overflow"]
    assert all(r["ep_overflow"] == losses for r in ranks)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_make_mesh_factorizations(ranks):
    r = ranks[0]["meshes"]
    assert r["dp"] == ("dp",) and r["dp_shape"] == (4,)
    assert r["dp_tp"] == (2, 2) and r["inferred"] == (2, 2)
    assert r["bad"].startswith("ValueError")


def test_hybrid_mesh_and_multihost_helpers(ranks):
    """One host: make_hybrid_mesh is make_mesh; distributed_init is a no-op
    outside torchrun; make_global_batch from each rank's rows equals
    shard_batch of the whole batch."""
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    for r in ranks:
        m = r["meshes"]
        assert m["hybrid"] == (("dp", "tp"), (2, 2))
        assert m["hybrid_bad"].startswith("ValueError")
        assert m["distributed_init"] is False
        shape, same, full = m["global_batch"]
        assert shape == (8, 4) and same
        np.testing.assert_array_equal(full, x)


def test_shard_batch_layout(ranks):
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    for r in ranks:
        placements, local, full = r["meshes"]["shard_batch"]
        assert placements == "(Shard(dim=0),)" and local == (2, 4)
        np.testing.assert_array_equal(full, x)


def test_data_parallel_matches_single_device(ranks):
    r = ranks[0]["data_parallel"]
    np.testing.assert_allclose(*r["w"], rtol=1e-5, atol=1e-5)
    assert abs(r["loss"][0] - r["loss"][1]) <= 1e-5


def test_sharded_trainer_on_mesh(ranks):
    """Trainer(mesh=) lowers its loss over 6 steps on a fixed batch, with
    and without fsdp, every rank seeing the same losses; its eval runs
    on the gathered params."""
    for fsdp in (False, True):
        losses = ranks[0]["trainer"][fsdp]
        assert all(r["trainer"][fsdp] == losses for r in ranks)
        assert losses[-1] < losses[0], losses
        assert np.isfinite(ranks[0]["trainer"][f"eval-{fsdp}"])


def test_sharded_trainer_resumes_exactly(ranks):
    """A Trainer(mesh=, fsdp=True) resumed from its step-3 checkpoint (a
    sharded save, restored into the ZeRO-3 layout) repeats the steps the
    first run took after it, bit for bit."""
    for r in ranks:
        t = r["trainer"]
        assert t["resumed_at"] == 3
        assert t["resumed"] == t[True][3:]


def test_sharded_checkpoint_restores_into_a_placement(ranks):
    for r in ranks:
        c = r["checkpoint"]
        assert c["placements"] == c["want"]
        np.testing.assert_array_equal(c["full"], c["saved"])
    # each rank holds its column half of the (8, 8) leaf (Shard(1) on dp)
    full = ranks[0]["checkpoint"]["saved"]
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["checkpoint"]["local"],
                                      np.hsplit(full, 2)[rank // 2])


def test_refusals_name_their_queue_item():
    """What the sharded tier still refuses raises before any collective:
    a pp axis in the sharded step (pipelines train through the pipelined
    steps, as JAX's), naming its queue item. Tensor-parallel serving,
    refused here before, runs (tests/test_torch_serving_tp.py); a mesh
    without dp and tp axes gets JAX's ValueError."""
    class Mesh:
        mesh_dim_names = ("dp", "pp")

    with pytest.raises(NotImplementedError, match=r"queue 1 item 5"):
        T.make_sharded_train_step(Mesh(), T.GPTConfig(**TINY))
    with pytest.raises(ValueError, match="'dp' and 'tp' axes"):
        T.make_generate(T.GPTConfig(**TINY), 4, mesh=Mesh())


@pytest.mark.parametrize("case", ["pp", "experts"])
def test_formerly_refused_cases_run(ranks, case):
    """The two cases the sharded tier refused before: a pp mesh trains
    through make_pipelined_train_step (its first loss is the unsharded
    loss), and experts train on a mesh without an ep axis (the dense
    dispatch, against the unsharded step)."""
    for r in ranks:
        got, want = r["accepted"][case]
        assert abs(got - want) <= TOL, (case, got, want)


def test_sharded_trainer_takes_an_ep_mesh(ranks):
    """Trainer(mesh=) on a dp2 x ep2 mesh (JAX's Trainer takes any mesh of
    the sharded step): the experts split over ep, the loss falling over
    four steps, the same on every rank."""
    losses, placements = ranks[0]["accepted"]["trainer_ep"]
    assert all(r["accepted"]["trainer_ep"][0] == losses for r in ranks)
    assert "Shard(dim=1)" in placements, placements
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_seq_parallel_config_builds_without_a_mesh():
    """seq_parallel only acts on a mesh, as in JAX: the unsharded step
    ignores it."""
    cfg = dataclasses.replace(T.GPTConfig(dtype=torch.float32, **TINY),
                              seq_parallel=True)
    p = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.randint(0, 32, (2, 16), generator=torch.Generator()
                         .manual_seed(1))
    base = T.loss_fn(p, toks, toks.roll(-1, 1),
                     dataclasses.replace(cfg, seq_parallel=False))
    assert float(T.loss_fn(p, toks, toks.roll(-1, 1), cfg)) == float(base)
