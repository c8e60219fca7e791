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
}
# JAX's sharded step is run for these (the rest: its unsharded step)
JAX_SHARDED = ("dp2tp2", "fsdp")


def _np_params(cfg_kw, seed=0):
    """A params tree of the JAX structure (the port's `param_shapes`),
    drawn with numpy: N(0, 0.02) matrices, unit scales, small biases."""
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

    return walk(T.param_shapes(T.GPTConfig(**cfg_kw)))


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
    try:
        T.fsdp_param_shardings(mesh2, T.GPTConfig(**TINY, n_experts=4),
                               min_size=0)
        moe = "no error"
    except NotImplementedError as e:
        moe = str(e)
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


def _rank(rank, jobs):
    import neuronika_tpu_torch as nk

    nk.config.device = "cpu"
    fns = {"steps": _job_steps, "meshes": _job_meshes,
           "data_parallel": _job_data_parallel, "trainer": _job_trainer,
           "checkpoint": _job_checkpoint}
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
            ("checkpoint", (str(tmp / "ck"),))]
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
        # the same math without interpret-mode kernels
        jcfg = JT.GPTConfig(dtype=jnp.float32, **dict(
            kw, flash="off", seq_parallel=False))
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
            mesh = JP.make_mesh(axes, devices=jax.devices()[:WORLD])
            out[name]["sharded"] = run(JT.make_sharded_train_step(
                mesh, jcfg, **step_kw))
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
    moment of the port's sharded step against JAX's unsharded step, and for dp2xtp2 and dp4
    with fsdp also against JAX's sharded step on the same mesh shape."""
    port = [r["steps"][name] for r in ranks]
    assert len({p["loss"] for p in port}) == 1
    assert port[0]["loss_type"] == "Tensor"
    for key, (jloss, jparams, jm) in jax_steps[name].items():
        assert abs(port[0]["loss"] - jloss) <= TOL, key
        _params_close(port[0]["params"], jparams)
        _moments_close(port[0]["m"], jm)


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
    # expert layouts come with _moe_mlp_ep
    assert "queue 1 item 5" in sp["moe_fc_in"]
    assert "dp" in sp["lm_head"] and "dp" in sp["fc_gate"]


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
    """What the sharded step does not take yet raises before any
    collective: pipeline and expert axes, and experts on a mesh."""
    class Mesh:
        mesh_dim_names = ("dp", "pp")

    with pytest.raises(NotImplementedError, match=r"queue 1 item 5"):
        T.make_sharded_train_step(Mesh(), T.GPTConfig(**TINY))
    Mesh.mesh_dim_names = ("dp",)
    with pytest.raises(NotImplementedError, match=r"queue 1 item 5"):
        T.make_sharded_train_step(Mesh(), T.GPTConfig(**TINY, n_experts=2))


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
