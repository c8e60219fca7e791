"""The define-by-run tier on dp-sharded leaves (the port's twin of
tests/test_parallel.py::test_define_by_run_with_sharded_leaves and of the
define-by-run section of JAX's `dryrun_multichip`), against the JAX
package on the CPU.

A leaf whose value `parallel.shard_batch` made (a DTensor, Shard(0) over
"dp") mixes with whole leaves in one tape; forward, backward and the
fused step must give the unsharded run's loss and gradients. Every case
runs in ONE spawn of 4 gloo ranks (`parallel.mesh.spawn`, met through a
FileStore under tmp_path; 60 s a collective, 240 s in all) while JAX
computes its references in this process. The ranks import this module,
so jax is imported only inside the functions that compute references.
f32; loss and gradients within TOL = 1e-5 (relative to the largest
entry, at least 1) of JAX's run, and of the port's own unsharded run
where JAX has no twin (the dropout node, the flash op alone).

Each rank's kernels must see only that rank's rows: spies on the
per-rank kernel entries of `ops/functional.py` (K1's `_attn_local`, K1
and the fused K2's `_attn_vjp_local`, K4's `_softmax_last`, K3's
`kernel_matmul`; on the CPU each runs its plain version) record the
local shapes they are handed, and the sharded run's must be the
unsharded run's with the split dim cut by the ranks (a rule that
gathered to Replicate would hand them the whole batch)."""

import concurrent.futures
import contextlib

import numpy as np
import pytest
import torch

WORLD = 4
PG_TIMEOUT = 60.0
RUN_LIMIT = 240.0
TOL = 1e-5

# test_parallel.py's twin: X (16, 4) split over dp, W (2, 4) whole
TWIN_SHAPES = ((16, 4), (2, 4))
# the dryrun's MLP: 4 rows a rank, SGD(0.05, L2(1e-4)), 2 fused steps
MLP_SIZES = (8, 16, 4)
MLP_STEPS = 2
# a small Var flagship (build_var_model_batched): hd 16, B 4 over 4 ranks
FLAG = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64,
            max_seq=8)
FLAG_B, FLAG_S = 4, 8
FLAG_LR = 1e-3
# the per-rank kernel entries of ops/functional.py the spies wrap
SPIED = ("_attn_local", "_attn_vjp_local", "_softmax_last", "kernel_matmul")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max err {err:.3e} > {tol:.0e} (of {scale:.3g})"


def _twin_data():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in TWIN_SHAPES)


def _mlp_data():
    rng = np.random.default_rng(1)
    n = 4 * WORLD
    return (rng.random((n, MLP_SIZES[0]), dtype=np.float32),
            rng.random((n, MLP_SIZES[-1]), dtype=np.float32))


# --------------------------------------------------------------------------
# the rank side


@contextlib.contextmanager
def _local_shapes():
    """{entry: [the shapes of each call's tensor operands]} of the kernel
    entries in SPIED, recorded while the block runs."""
    from neuronika_tpu_torch.ops import functional as F

    seen = {n: [] for n in SPIED}
    real = {n: getattr(F, n) for n in SPIED}

    def spy(name):
        def call(*args, **kw):
            seen[name].append(tuple(tuple(a.shape) for a in args
                                    if isinstance(a, torch.Tensor)))
            return real[name](*args, **kw)
        return call

    for n in SPIED:
        setattr(F, n, spy(n))
    try:
        yield seen
    finally:
        for n in SPIED:
            setattr(F, n, real[n])


def _twin(nk, P, X, W, kernels):
    """The twin of test_parallel.py:120: mm_t, relu, mse on a sharded x."""
    nk.enable_kernels(kernels)
    try:
        mesh = P.make_mesh()
        x = nk.from_ndarray(X)
        x.node.value = P.shard_batch(x.node.value, mesh)
        w = nk.from_ndarray(W).requires_grad()
        loss = x.mm_t(w).relu().mse(nk.zeros((16, 2)), nk.Reduction.Mean)
        with _local_shapes() as seen:
            loss.forward()
            loss.backward(1.0)
        return (loss.data().numpy(), w.grad().numpy(),
                type(loss.data()).__name__, type(w.grad()).__name__,
                seen["kernel_matmul"])
    finally:
        nk.enable_kernels(False)


def _mlp(nk, P, weights, Xn, Yn):
    """The dryrun's define-by-run section: MLP((8, 16, 4)), SGD(0.05,
    L2(1e-4)), MLP_STEPS fused steps, x sharded anew each step."""
    from neuronika_tpu_torch import models, nn, optim

    mesh = P.make_mesh()
    mlp = models.MLP(MLP_SIZES)
    nn.params_from_jax(mlp, weights)
    opt = optim.SGD(0.05, optim.L2(1e-4))
    opt.register_all(mlp.parameters())
    losses = []
    for _ in range(MLP_STEPS):
        x = nk.from_ndarray(Xn)
        x.node.value = P.shard_batch(x.node.value, mesh)
        loss = mlp.forward(x).mse(nk.from_ndarray(Yn), nk.Reduction.Mean)
        losses.append(opt.train_step(loss, block=True))
    return losses, [p.data().numpy() for p in mlp.parameters()]


def _cache(nk, P):
    """A sharded and an unsharded tape of one structure: two programs."""
    from neuronika_tpu_torch._engine import executor

    mesh = P.make_mesh()
    X, W = _twin_data()

    def tape(sharded):
        x = nk.from_ndarray(X)
        if sharded:
            x.node.value = P.shard_batch(x.node.value, mesh)
        w = nk.from_ndarray(W).requires_grad()
        return x.mm_t(w).relu().sum()

    executor.clear_cache()
    plain, split = tape(False), tape(True)
    sigs = [executor._plan_and_sign(t.node)[2] for t in (plain, split)]
    counts = []
    for t in (plain, split, tape(False), tape(True)):
        t.forward()
        counts.append(executor.cache_stats()[0])
    return sigs[0] != sigs[1], counts, float(plain.data()), \
        float(split.data())


def _flagship(nk, T, P, fused):
    """A small `build_var_model_batched` (kernels on: on the CPU the K1/K2
    composite and K4's plain version through each rank's rows) on sharded
    ids and on whole ids: {split: (values, tensors, local shapes)}. fused:
    two Adam fused steps (losses, then the parameters); else one forward
    and backward (loss, then every parameter's gradient)."""
    from neuronika_tpu_torch import optim

    nk.enable_kernels(True)
    try:
        cfg = T.GPTConfig(dtype=torch.float32, dropout=0.0, flash_block=8,
                          **FLAG)
        ids = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (FLAG_B, FLAG_S)).astype("float32")
        tgt = np.roll(ids, -1, axis=1).reshape(-1)
        out = {}
        for split in (False, True):
            np.random.seed(0)
            params, fwd = T.build_var_model_batched(cfg, FLAG_B, FLAG_S,
                                                    device="cpu")
            x = nk.from_ndarray(ids)
            if split:
                x.node.value = P.shard_batch(x.node.value, P.make_mesh())
            loss = fwd(x).reshape((FLAG_B * FLAG_S, cfg.vocab_size)) \
                .log_softmax(1).t().nll(nk.from_ndarray(tgt),
                                        nk.Reduction.Mean)
            with _local_shapes() as seen:
                if fused:
                    opt = optim.Adam(FLAG_LR)
                    opt.register_all(params)
                    vals = [opt.train_step(loss) for _ in range(2)]
                else:
                    loss.forward()
                    loss.backward(1.0)
                    vals = [float(loss.data())]
            tensors = [(p.data() if fused else p.grad()).numpy()
                       for p in params]
            out[split] = (vals, tensors, seen)
        return out
    finally:
        nk.enable_kernels(False)


def _dropout(nk, P):
    """A dropout node on a sharded leaf draws the unsharded run's mask:
    same values and same gradient."""
    from neuronika_tpu_torch.variable import StatusCell

    X = np.random.default_rng(3).standard_normal((16, 6)).astype(np.float32)
    outs = []
    for split in (False, True):
        nk.seed(5)
        x = nk.from_ndarray(X).requires_grad()
        if split:
            x.node.value = P.shard_batch(x.node.value, P.make_mesh())
        y = x.dropout(0.5, StatusCell(True))
        loss = (y * y).sum()
        loss.forward()
        loss.backward(1.0)
        outs.append((y.data().numpy(), x.grad().numpy(),
                     float(loss.data())))
    return outs


def _flash(nk, P):
    """The Var flash op on a sharded qkv: at dropout 0 each rank's rows
    give the unsharded run's output and gradient; with dropout the op
    refuses (the kernels' mask counts the batch row from 0 on each
    rank)."""
    from neuronika_tpu_torch.variable import StatusCell

    Q = np.random.default_rng(4).standard_normal((4, 8, 48)).astype(
        np.float32)
    outs = []
    for split in (False, True):
        q = nk.from_ndarray(Q).requires_grad()
        if split:
            q.node.value = P.shard_batch(q.node.value, P.make_mesh())
        y = q.flash_attention(2, causal=True)
        loss = (y * y).sum()
        loss.forward()
        loss.backward(1.0)
        outs.append((y.data().numpy(), q.grad().numpy()))
    q = nk.from_ndarray(Q)
    q.node.value = P.shard_batch(q.node.value, P.make_mesh())
    y = q.flash_attention(2, causal=True, dropout=0.1,
                          status=StatusCell(True))
    try:
        y.forward()
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    return outs, refused


def _rank(rank, jobs):
    import neuronika_tpu_torch as nk
    from neuronika_tpu_torch import parallel as P
    from neuronika_tpu_torch.models import transformer as T

    nk.config.device = "cpu"
    X, W = _twin_data()
    out = {"twin": _twin(nk, P, X, W, False),
           "twin_kernels": _twin(nk, P, X, W, True),
           "mlp": _mlp(nk, P, jobs["mlp_weights"], *_mlp_data()),
           "cache": _cache(nk, P),
           "flag_grad": _flagship(nk, T, P, fused=False),
           "flag_fused": _flagship(nk, T, P, fused=True),
           "dropout": _dropout(nk, P),
           "flash": _flash(nk, P)}
    return out


# --------------------------------------------------------------------------
# the JAX side


def _jax_mlp():
    """JAX's MLP weights, and its losses and parameters after MLP_STEPS
    fused steps on sharded x over 4 of conftest's virtual devices."""
    import jax

    import neuronika_tpu as jk
    from neuronika_tpu import models, optim, parallel

    jk.seed(0)
    mlp = models.MLP(MLP_SIZES)
    weights = [np.asarray(p.data()).copy() for p in mlp.parameters()]
    opt = optim.SGD(0.05, optim.L2(1e-4))
    opt.register_all(mlp.parameters())
    mesh = parallel.make_mesh([("dp", WORLD)], devices=jax.devices()[:WORLD])
    Xn, Yn = _mlp_data()
    losses = []
    for _ in range(MLP_STEPS):
        x = jk.from_ndarray(Xn)
        x.node.value = parallel.shard_batch(x.node.value, mesh)
        loss = mlp.forward(x).mse(jk.from_ndarray(Yn), jk.Reduction.Mean)
        opt.train_step(loss, block=True)
        losses.append(float(loss.item()))
    return weights, losses, [np.asarray(p.data()) for p in mlp.parameters()]


def _jax_twin():
    import neuronika_tpu as jk

    X, W = _twin_data()
    x, w = jk.from_ndarray(X), jk.from_ndarray(W).requires_grad()
    loss = x.mm_t(w).relu().mse(jk.zeros((16, 2)), jk.Reduction.Mean)
    loss.forward()
    loss.backward(1.0)
    return np.asarray(loss.data()), np.asarray(w.grad())


def _jax_flagship():
    """JAX's `build_var_model_batched` (the same np.random draw as the
    port's) on ids sharded over 4 of conftest's virtual devices: {fused:
    (values, tensors)} as `_flagship` returns them."""
    import jax
    import jax.numpy as jnp

    import neuronika_tpu as jk
    from neuronika_tpu import optim, parallel
    from neuronika_tpu.models import transformer as JT

    cfg = JT.GPTConfig(dtype=jnp.float32, dropout=0.0, flash_block=8,
                       **FLAG)
    ids = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (FLAG_B, FLAG_S)).astype("float32")
    tgt = np.roll(ids, -1, axis=1).reshape(-1)
    mesh = parallel.make_mesh([("dp", WORLD)], devices=jax.devices()[:WORLD])
    out = {}
    for fused in (False, True):
        np.random.seed(0)
        params, fwd = JT.build_var_model_batched(cfg, FLAG_B, FLAG_S)
        x = jk.from_ndarray(ids)
        x.node.value = parallel.shard_batch(x.node.value, mesh)
        loss = fwd(x).reshape((FLAG_B * FLAG_S, cfg.vocab_size)) \
            .log_softmax(1).t().nll(jk.from_ndarray(tgt), jk.Reduction.Mean)
        if fused:
            opt = optim.Adam(FLAG_LR)
            opt.register_all(params)
            vals = [opt.train_step(loss) for _ in range(2)]
            out[fused] = (vals, [np.asarray(p.data()) for p in params])
        else:
            loss.forward()
            loss.backward(1.0)
            out[fused] = ([float(loss.item())],
                          [np.asarray(p.grad()) for p in params])
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from neuronika_tpu_torch.parallel.mesh import spawn

    weights, losses, params = _jax_mlp()
    init = str(tmp_path_factory.mktemp("var_sharded") / "store")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, _rank, WORLD, ({"mlp_weights": weights},),
                          init_file=init, timeout=PG_TIMEOUT,
                          limit=RUN_LIMIT)
        twin = _jax_twin()
        flag = _jax_flagship()
        ranks = fut.result()
    return {"ranks": ranks, "jax_twin": twin, "jax_flag": flag,
            "jax_mlp": (losses, params)}


@pytest.mark.parametrize("case", ["twin", "twin_kernels"])
def test_sharded_leaves_match_jax_unsharded(results, case):
    """Loss and w.grad() of the sharded tape within 1e-5 of JAX's
    unsharded run, whole and equal on every rank (plain tensors)."""
    want_loss, want_grad = results["jax_twin"]
    for r in results["ranks"]:
        loss, grad, loss_t, grad_t, _ = r[case]
        assert (loss_t, grad_t) == ("Tensor", "Tensor")
        _close(loss, want_loss)
        _close(grad, want_grad)
        np.testing.assert_array_equal(grad, results["ranks"][0][case][1])


def test_k3_sees_each_ranks_rows(results):
    """The twin with kernels on: every K3 call gets the rank's 16 / 4 rows
    of x or of the upstream gradient, never the whole 16: x w^T, the
    gradient's g w (its left operand's, which the tape computes though
    x needs none) and g^T x (the weight gradient, a partial sum a rank)."""
    n = TWIN_SHAPES[0][0] // WORLD
    want = [((n, 4), (4, 2)), ((n, 2), (2, 4)), ((2, n), (n, 4))]
    for r in results["ranks"]:
        assert r["twin_kernels"][4] == want
        assert r["twin"][4] == []          # kernels off: no K3


def test_fused_mlp_steps_match_jax(results):
    """The dryrun's MLP with SGD(0.05, L2(1e-4)): the fused steps' losses
    and the parameters after them within 1e-5 of JAX's sharded run (the
    L2 penalty added once, not dp times)."""
    losses, params = results["jax_mlp"]
    for r in results["ranks"]:
        got_losses, got_params = r["mlp"]
        _close(got_losses, losses)
        assert got_losses[1] < got_losses[0]
        for g, w in zip(got_params, params):
            _close(g, w)


def test_sharded_tape_has_its_own_program(results):
    """Equal structure, sharded or not: the signatures differ and each
    tape gets its own cache entry (two entries, reused on a rebuild)."""
    for r in results["ranks"]:
        differ, counts, plain, split = r["cache"]
        assert differ
        assert counts == [1, 2, 2, 2]
        assert abs(plain - split) <= TOL * max(1.0, abs(plain))


@pytest.mark.parametrize("mode", ["flag_grad", "flag_fused"])
def test_var_flagship_on_sharded_ids(results, mode):
    """build_var_model_batched on dp-sharded ids (the flash op and the
    loss head's log-softmax run on each rank's rows): the loss and every
    gradient (backward), or two Adam steps' losses and parameters (fused
    step), within 1e-5 of JAX's run on ids sharded over 4 virtual
    devices, and of the port's same graph on whole ids."""
    want_vals, want = results["jax_flag"][mode == "flag_fused"]
    for r in results["ranks"]:
        out = r[mode]
        (l0, t0, _), (l1, t1, _) = out[False], out[True]
        _close(l1, want_vals)
        _close(l1, l0)
        assert len(t0) == len(t1) == len(want) == 4 + 10 * FLAG["n_layer"]
        for a, b, w in zip(t1, t0, want):
            _close(a, w)
            _close(a, b)


def _rows_cut(calls):
    return [tuple((s[0] // WORLD,) + s[1:] for s in call) for call in calls]


@pytest.mark.parametrize("mode", ["flag_grad", "flag_fused"])
def test_var_flagship_kernels_see_each_ranks_rows(results, mode):
    """K1 (forward, and again inside the vjp), the fused K2 and K4 get
    each rank's rows: call for call the whole-ids run's operands with
    their batch dim (B for K1/K2, N = B S for K4) cut by the 4 ranks."""
    for r in results["ranks"]:
        whole, split = r[mode][False][2], r[mode][True][2]
        for name in ("_attn_local", "_attn_vjp_local", "_softmax_last"):
            assert whole[name], name
            assert split[name] == _rows_cut(whole[name]), name
        assert split["_attn_local"][0] == (
            (FLAG_B // WORLD, FLAG_S, 3 * FLAG["d_model"]),)
        assert split["_softmax_last"][0] == (
            (FLAG_B * FLAG_S // WORLD, FLAG["vocab_size"]),)


def test_dropout_on_sharded_leaf_draws_unsharded_rows(results):
    for r in results["ranks"]:
        (y0, g0, l0), (y1, g1, l1) = r["dropout"]
        np.testing.assert_array_equal(y1, y0)
        np.testing.assert_array_equal(g1, g0)
        assert (y0 == 0).any() and (y0 != 0).any()
        _close(l1, l0)


def test_flash_op_on_sharded_qkv(results):
    """At dropout 0 the op's output and gradient on each rank's rows are
    the unsharded run's (within 1e-5); with dropout on a split batch the
    op raises, naming the ROADMAP item."""
    for r in results["ranks"]:
        ((y0, g0), (y1, g1)), refused = r["flash"]
        _close(y1, y0)
        _close(g1, g0)
        assert refused is not None and "queue 1 item 5" in refused
