"""Tensor-parallel serving in the port (`make_generate(mesh=)`,
`ContinuousBatcher(mesh=)`, `PagedBatcher(mesh=)`: kv heads over "tp",
proj's and fc_out's products all-reduced, K11 on each rank's own pool)
against the JAX package's mesh programs and the port's single-device runs
on the CPU, mirroring tests/test_parallel.py's
test_sharded_generate_matches_single_device, its bad-mesh refusals and
TestBatcherOnMesh.

Every case runs in ONE spawn of 4 gloo ranks (`parallel.mesh.spawn`, met
through a FileStore under tmp_path; 60 s a collective, 240 s in all), in
a thread while this process computes JAX's references on conftest's
8-device virtual mesh (its first 4 devices, the same mesh shapes) and the
port's single-device runs. The ranks import this module to find their
work, so jax is imported only inside the functions that compute the
references. f32 and tiny GPTs (d64 L2 H4, as TestBatcherOnMesh's); greedy
tokens must be equal token for token, sampled ones equal to the port's
single-device run (JAX's PRNG draws other bits)."""

import concurrent.futures
import sys

import numpy as np
import pytest
import torch

from neuronika_tpu_torch import parallel as P
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.serving import ContinuousBatcher, PagedBatcher

WORLD = 4
PG_TIMEOUT = 60.0         # s a collective may wait
RUN_LIMIT = 240.0         # s the spawned run may take
CFG = dict(vocab_size=64, n_layer=2, n_head=4, d_model=64, d_ff=128,
           max_seq=48)
MESHES = {"dp2tp2": [("dp", 2), ("tp", 2)], "tp4": [("dp", 1), ("tp", 4)]}
# make_generate's cases: every quant mode on both meshes. int4 groups 128
# rows, or the whole axis where 128 does not divide it: proj's 64 rows are
# one group, which tp2 and tp4 split (fc_out's 128 too)
GEN = [(m, q) for m in MESHES for q in (None, "int8", "int4", "int8-kv")]
GEN_B, GEN_P, GEN_NEW = 8, 8, 12
# the other families on a mesh: Mistral's (rope, RMSNorm, SwiGLU, no
# biases, an untied head, 8 query heads over 2 kv heads, a window; int4
# splits fc_out's one group of 96 rows) and the MoE GPT's (experts held
# whole on every rank), as (family, GPTConfig fields, mesh, quant)
MISTRAL = dict(vocab_size=64, n_layer=2, n_head=8, n_kv_head=2, d_model=64,
               d_ff=96, max_seq=48, window=6)
FAMILIES = [("mistral", MISTRAL, "dp2tp2", None),
            ("mistral", MISTRAL, "dp2tp2", "int4"),
            ("moe", dict(CFG, n_experts=4), "tp4", None)]
# the planted outlier: kv group 3's v columns of qkv (G 1: group g's
# columns are [q_g | k_g | v_g], hd 16 each) scaled up, so that head 3's
# features of proj's input, on the last tp rank, dwarf the other ranks'.
# A rank scaling by its own amax would quantize the others' features
# finer than JAX's whole-row scale does
OUTLIER_COLS = slice(3 * 48 + 32, 3 * 48 + 48)
OUTLIER_SCALE = 300.0
LOGITS_REL = 1e-5         # f32: the tp ranks' partial sums reordered
PREFIX = np.array([5, 6, 7, 8, 9, 10, 11, 12], np.int32)


def _np_params(cfg_kw, std=0.08, seed=0, family="gpt"):
    """A params tree of the port's structure drawn with numpy: N(0, std)
    matrices, unit scales, small biases (std 0.08 makes greedy tokens
    vary where JAX's 0.02 init repeats one)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if path.endswith("scale"):
            return np.ones(tree.shape, np.float32)
        s = 0.02 if path.endswith(("_b", "bias")) else std
        return (s * rng.standard_normal(tree.shape)).astype(np.float32)

    return walk(T.param_shapes(_family_cfg(family, cfg_kw)))


def _family_cfg(family, kw):
    make = T.mistral_config if family == "mistral" else T.GPTConfig
    return make(dtype=torch.float32, **kw)


def _outlier_params():
    p = _np_params(CFG, seed=1)
    p["blocks"]["qkv"][:, :, OUTLIER_COLS] *= OUTLIER_SCALE
    return p


def _lora(seed=2, r=2):
    """One adapter on a column-parallel (qkv, fc_in) and a row-parallel
    (proj, fc_out) leaf of each kind."""
    rng = np.random.default_rng(seed)
    L, D, F = CFG["n_layer"], CFG["d_model"], CFG["d_ff"]
    shapes = {"qkv": (D, 3 * D), "proj": (D, D), "fc_in": (D, F),
              "fc_out": (F, D)}
    return {k: {"A": rng.standard_normal((L, i, r)).astype(np.float32)
                / np.sqrt(r),
                "B": (0.05 * rng.standard_normal((L, r, o)))
                .astype(np.float32)}
            for k, (i, o) in shapes.items()}


def _prompts():
    return np.random.default_rng(3).integers(
        0, CFG["vocab_size"], (GEN_B, GEN_P)).astype(np.int32)


# TestBatcherOnMesh's requests (the second sampled)
WORK_PROMPTS = [np.array([1, 2, 3, 4], np.int32), np.array([7, 8], np.int32),
                np.array([9, 10, 11, 12, 13, 14, 15, 16], np.int32)]
WORK_NEWS = [10, 4, 7]
WORK_KWS = [{}, dict(temperature=0.9, top_k=8, seed=3), {}]
GROUPED = [np.array([1, 2, 3, 4], np.int32), np.array([5, 6, 7, 8], np.int32),
           np.array([9, 10, 11, 12], np.int32)]
# chunked prefill (a 14-token prompt in chunks of 4), a registered prefix
# and one adapter, in one run
FEATURE_PROMPTS = [np.arange(20, 34, dtype=np.int32),
                   np.concatenate([PREFIX, [40, 41, 42]]).astype(np.int32),
                   np.array([3, 1, 4, 1, 5], np.int32)]
FEATURE_KWS = [{}, {}, dict(adapter=1)]
PAGED = dict(n_blocks=5, block_size=4)
# (batcher, mesh, constructor keywords, run) of each batcher workload
WORKLOADS = {
    "dense_multi_step": ("dense", "dp2tp2", dict(n_slots=2), "work"),
    "dense_grouped": ("dense", "dp2tp2", dict(n_slots=3), "grouped"),
    "dense_features": ("dense", "tp4", dict(n_slots=2, prefill_chunk=4),
                       "features"),
    "paged_preemption": ("paged", "dp2tp2", dict(n_slots=2, **PAGED),
                         "work"),
    "paged_preemption_tp4": ("paged", "tp4", dict(n_slots=2, **PAGED),
                             "work"),
    "paged_grouped": ("paged", "dp2tp2", dict(n_slots=3, n_blocks=16,
                                              block_size=4), "grouped"),
    "paged_features": ("paged", "dp2tp2", dict(n_slots=2, n_blocks=24,
                                               block_size=4,
                                               prefill_chunk=4),
                       "features"),
}


def _drive(b, run):
    """Submit a workload's requests to batcher `b` and run it: (tokens in
    submission order, the batcher's facts)."""
    if run == "work":
        rids = [b.submit(p, m, **kw)
                for p, m, kw in zip(WORK_PROMPTS, WORK_NEWS, WORK_KWS)]
        done = b.run(multi_step=1 if isinstance(b, PagedBatcher) else 2)
    elif run == "grouped":
        with b.defer_admission():
            rids = [b.submit(p, 8, temperature=0.6, seed=i)
                    for i, p in enumerate(GROUPED)]
        done = b.run(multi_step=4)
    else:
        b.register_prefix(PREFIX)
        assert b.register_adapter(_lora()) == 1
        rids = [b.submit(p, 6, **kw)
                for p, kw in zip(FEATURE_PROMPTS, FEATURE_KWS)]
        done = b.run()
    facts = {"grouped": b._multi_prefill is not None,
             "preemptions": getattr(b, "preemptions", 0),
             "kernel": getattr(b, "kernel", None)}
    return [done[r].tolist() for r in rids], facts


def _batcher(kind, params, cfg, mesh, kw):
    cls = ContinuousBatcher if kind == "dense" else PagedBatcher
    return cls(params, cfg, device="cpu", mesh=mesh, **kw)


# --------------------------------------------------------------------------
# the rank side


def _job_generate(rank):
    """make_generate(mesh=) on each GEN case, greedy, and one sampled
    case: the whole (B, P + max_new) every rank returns."""
    cfg = T.GPTConfig(dtype=torch.float32, **CFG)
    params = T.params_from_jax(_np_params(CFG))
    prompt = torch.from_numpy(_prompts())
    out = {}
    for mesh_name, quant in GEN:
        gen = T.make_generate(cfg, GEN_NEW, quant=quant,
                              mesh=P.make_mesh(MESHES[mesh_name]))
        out[(mesh_name, quant)] = gen(params, prompt).numpy()
    gen = T.make_generate(cfg, GEN_NEW, temperature=0.9, top_k=16,
                          mesh=P.make_mesh(MESHES["dp2tp2"]))
    out["sampled"] = gen(params, prompt,
                         torch.Generator().manual_seed(5)).numpy()
    for family, kw, mesh_name, quant in FAMILIES:
        cfg = _family_cfg(family, kw)
        gen = T.make_generate(cfg, GEN_NEW, quant=quant,
                              mesh=P.make_mesh(MESHES[mesh_name]))
        params = T.params_from_jax(_np_params(kw, family=family))
        out[(family, quant)] = gen(params, prompt).numpy()
    return out


def _job_outlier(rank):
    """W8A8 with the planted outlier on dp2 x tp2: the dense batcher's
    prefill logits of one prompt and make_generate's tokens."""
    cfg = T.GPTConfig(dtype=torch.float32, **CFG)
    params = T.params_from_jax(_outlier_params())
    mesh = P.make_mesh(MESHES["dp2tp2"])
    b = ContinuousBatcher(params, cfg, n_slots=1, quant="int8",
                          device="cpu", mesh=mesh)
    prompt = torch.from_numpy(_prompts()[:1])
    logits, _ = b._prefill(b.params, b.cache, prompt, 0)
    gen = T.make_generate(cfg, GEN_NEW, quant="int8", mesh=mesh)
    return {"logits": logits.numpy(),
            "tokens": gen(params, torch.from_numpy(_prompts())).numpy()}


def _job_batchers(rank):
    """Each WORKLOAD on its mesh; the paged runs record K11's first decode
    call (operands and result) and its calls."""
    cfg = T.GPTConfig(dtype=torch.float32, **CFG)
    params = T.params_from_jax(_np_params(CFG))
    real = T.paged_attention
    out = {}
    for name, (kind, mesh_name, kw, run) in WORKLOADS.items():
        shapes, first = [], []

        def spy(q, pk, pv, table, pos, **k):
            o = real(q, pk, pv, table, pos, **k)
            shapes.append(tuple(q.shape))
            if not first:
                first.extend(t.numpy().copy()
                             for t in (q, pk, pv, table, pos, o))
            return o

        T.paged_attention = spy
        try:
            b = _batcher(kind, params, cfg, P.make_mesh(MESHES[mesh_name]),
                         kw)
            steps, step = [], b._step

            def counted(*a):
                steps.append(1)
                return step(*a)

            b._step = counted
            toks, facts = _drive(b, run)
        finally:
            T.paged_attention = real
        facts.update(k11_first=first, k11_shapes=sorted(set(shapes)),
                     k11_calls=len(shapes), decode_steps=len(steps))
        out[name] = (toks, facts)
    return out


def _job_refusals(rank):
    """JAX's three ValueErrors on real meshes: no tp axis, no dp and tp
    axes (make_generate), kv_heads % tp."""
    cfg = T.GPTConfig(dtype=torch.float32, **CFG)
    odd_kw = dict(CFG, n_head=3, d_model=48)
    odd = T.GPTConfig(dtype=torch.float32, **odd_kw)
    params = T.params_from_jax(_np_params(CFG))
    odd_params = T.params_from_jax(_np_params(odd_kw))
    dp4, pp4 = P.make_mesh([("dp", 4)]), P.make_mesh([("pp", 4)])
    dp2tp2 = P.make_mesh(MESHES["dp2tp2"])
    cases = {
        "batcher_no_tp": lambda: ContinuousBatcher(
            params, cfg, 2, device="cpu", mesh=dp4),
        "paged_no_tp": lambda: PagedBatcher(
            params, cfg, 2, 5, 4, device="cpu", mesh=dp4),
        "generate_no_dp_tp": lambda: T.make_generate(cfg, 4, mesh=pp4),
        "generate_kv_heads": lambda: T.make_generate(odd, 4, mesh=dp2tp2),
        "batcher_kv_heads": lambda: ContinuousBatcher(
            odd_params, odd, 2, device="cpu", mesh=dp2tp2),
        "paged_kv_heads": lambda: PagedBatcher(
            odd_params, odd, 2, 5, 4, device="cpu", mesh=dp2tp2),
    }
    out = {}
    for name, call in cases.items():
        try:
            call()
            out[name] = "no error"
        except ValueError as e:
            out[name] = str(e)
    return out


def _rank(rank, jobs):
    import neuronika_tpu_torch as nk

    nk.config.device = "cpu"
    fns = {"generate": _job_generate, "outlier": _job_outlier,
           "batchers": _job_batchers, "refusals": _job_refusals}
    out = {name: fns[name](rank) for name in jobs}
    out["jax_loaded"] = [m for m in ("jax", "neuronika_tpu")
                         if m in sys.modules]
    return out


# --------------------------------------------------------------------------
# this process: the fixtures, JAX's references and the port's single-device
# runs


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(P.mesh.spawn, _rank, WORLD,
                         (["generate", "outlier", "batchers", "refusals"],),
                         init_file=str(tmp / "store"), timeout=PG_TIMEOUT,
                         limit=RUN_LIMIT)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_refs(launched):
    """JAX's mesh programs (on its first 4 virtual devices) and unsharded
    programs for the GEN cases; its int8 prefill logits and tokens for
    the outlier; its refusals' messages."""
    import jax
    import jax.numpy as jnp

    from neuronika_tpu import parallel as JP
    from neuronika_tpu import serving as JS
    from neuronika_tpu.models import transformer as JT

    jcfg = JT.GPTConfig(dtype=jnp.float32, flash="off", **CFG)
    params = jax.tree.map(jnp.asarray, _np_params(CFG))
    prompt = jnp.asarray(_prompts())
    key = jax.random.key(0)
    out = {}
    for mesh_name, quant in GEN:
        mesh = JP.make_mesh(MESHES[mesh_name], devices=jax.devices()[:WORLD])
        out[(mesh_name, quant)] = (
            np.asarray(JT.make_generate(jcfg, GEN_NEW, quant=quant,
                                        mesh=mesh)(params, prompt, key)),
            np.asarray(JT.make_generate(jcfg, GEN_NEW, quant=quant)(
                params, prompt, key)))
    op = jax.tree.map(jnp.asarray, _outlier_params())
    logits, _ = JT.make_prefill(jcfg, "int8")(
        op, JT.init_kv_cache(jcfg, 1), prompt[:1])
    out["outlier"] = {
        "logits": np.asarray(logits)[0],
        "tokens": np.asarray(JT.make_generate(jcfg, GEN_NEW, quant="int8")(
            op, prompt, key))}
    for family, kw, mesh_name, quant in FAMILIES:
        make = JT.mistral_config if family == "mistral" else JT.GPTConfig
        fcfg = make(dtype=jnp.float32, flash="off", **kw)
        fp = jax.tree.map(jnp.asarray, _np_params(kw, family=family))
        mesh = JP.make_mesh(MESHES[mesh_name], devices=jax.devices()[:WORLD])
        out[(family, quant)] = (
            np.asarray(JT.make_generate(fcfg, GEN_NEW, quant=quant,
                                        mesh=mesh)(fp, prompt, key)),
            np.asarray(JT.make_generate(fcfg, GEN_NEW, quant=quant)(
                fp, prompt, key)))
    devs = jax.devices()[:WORLD]
    odd = JT.GPTConfig(dtype=jnp.float32, flash="off",
                       **dict(CFG, n_head=3, d_model=48))
    msgs = {}
    for name, call in (
            ("no_tp", lambda: JS.ContinuousBatcher(
                params, jcfg, 2, mesh=JP.make_mesh([("dp", 4)],
                                                   devices=devs))),
            ("no_dp_tp", lambda: JT.make_generate(
                jcfg, 4, mesh=JP.make_mesh([("pp", 4)], devices=devs))),
            ("kv_heads", lambda: JT.make_generate(
                odd, 4, mesh=JP.make_mesh(MESHES["dp2tp2"],
                                          devices=devs)))):
        with pytest.raises(ValueError) as e:
            call()
        msgs[name] = str(e.value)
    out["messages"] = msgs
    return out


@pytest.fixture(scope="module")
def port_refs(launched):
    """The port's single-device runs of the same cases."""
    torch.set_num_threads(1)
    cfg = T.GPTConfig(dtype=torch.float32, **CFG)
    params = T.params_from_jax(_np_params(CFG))
    prompt = torch.from_numpy(_prompts())
    out = {q: T.make_generate(cfg, GEN_NEW, quant=q)(params, prompt).numpy()
           for q in {q for _, q in GEN}}
    out["sampled"] = T.make_generate(cfg, GEN_NEW, temperature=0.9,
                                     top_k=16)(
        params, prompt, torch.Generator().manual_seed(5)).numpy()
    for family, kw, _, quant in FAMILIES:
        out[(family, quant)] = T.make_generate(
            _family_cfg(family, kw), GEN_NEW, quant=quant)(
            T.params_from_jax(_np_params(kw, family=family)), prompt).numpy()
    for name, (kind, _, kw, run) in WORKLOADS.items():
        out[name] = _drive(_batcher(kind, params, cfg, None, kw), run)
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_refs, port_refs):
    """The ranks' results: a list, one dict a rank."""
    return launched.result()


@pytest.mark.parametrize("mesh_name, quant", GEN,
                         ids=[f"{m}-{q}" for m, q in GEN])
def test_generate_matches_jax_and_one_device(ranks, jax_refs, port_refs,
                                             mesh_name, quant):
    """make_generate(mesh=) returns the whole (B, P + max_new) on every
    rank: JAX's mesh program's greedy tokens, its unsharded program's and
    the port's single-device run's, token for token (int8: every rank
    scales by the whole weight's scales and the whole row's amax; int4:
    tp cuts one quant group of proj and fc_out; int8-kv: each rank's
    heads' scales)."""
    got = [r["generate"][(mesh_name, quant)] for r in ranks]
    assert got[0].shape == (GEN_B, GEN_P + GEN_NEW)
    assert all(np.array_equal(g, got[0]) for g in got)
    jax_mesh, jax_one = jax_refs[(mesh_name, quant)]
    np.testing.assert_array_equal(got[0], jax_mesh)
    np.testing.assert_array_equal(got[0], jax_one)
    np.testing.assert_array_equal(got[0], port_refs[quant])


@pytest.mark.parametrize("family, quant", [(f, q) for f, _, _, q in FAMILIES],
                         ids=[f"{f}-{q}" for f, _, _, q in FAMILIES])
def test_families_on_a_mesh_match_jax_and_one_device(ranks, jax_refs,
                                                     port_refs, family,
                                                     quant):
    """Mistral's family (GQA: each rank 4 query heads over its 1 kv head;
    rope on the rank's heads; SwiGLU's fc_gate split as fc_in; no biases;
    int4 splitting a group of 96 rows) and the MoE GPT (its experts whole
    on every rank, the attention split) on a mesh: JAX's mesh program's
    greedy tokens, its unsharded program's and the port's one-device
    run's."""
    got = [r["generate"][(family, quant)] for r in ranks]
    assert all(np.array_equal(g, got[0]) for g in got)
    jax_mesh, jax_one = jax_refs[(family, quant)]
    np.testing.assert_array_equal(got[0], jax_mesh)
    np.testing.assert_array_equal(got[0], jax_one)
    np.testing.assert_array_equal(got[0], port_refs[(family, quant)])


def test_sampled_generate_draws_as_the_whole_batch(ranks, port_refs):
    """A sampled dp shard draws the whole batch's noise and keeps its rows:
    with the same generator state the tokens on dp2 x tp2 are the
    unsharded run's."""
    for r in ranks:
        np.testing.assert_array_equal(r["generate"]["sampled"],
                                      port_refs["sampled"])


def test_int8_scales_by_the_whole_rows_amax(ranks, jax_refs):
    """The planted outlier lies in the last tp rank's half of proj's input:
    JAX quantizes every token by its whole row's amax, so the port's
    logits must be JAX's within f32 reordering, and its tokens JAX's. Each
    rank scaling by its own amax moves the logits by orders more."""
    ref = jax_refs["outlier"]
    for r in ranks:
        got = r["outlier"]["logits"]
        err = np.abs(got - ref["logits"]).max()
        assert err <= LOGITS_REL * np.abs(ref["logits"]).max(), err
        np.testing.assert_array_equal(r["outlier"]["tokens"], ref["tokens"])


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_batcher_on_mesh_matches_one_device(ranks, port_refs, name):
    """TestBatcherOnMesh's workloads (multi-step windows, grouped admission
    of a deferred burst, paged preemption at 5 blocks of 4) and chunked
    prefill with a registered prefix and one adapter on a column- and a
    row-parallel leaf of each kind: every rank's tokens are the port's
    single-device batcher's, greedy and sampled rows alike."""
    want, want_facts = port_refs[name]
    for r in ranks:
        toks, facts = r["batchers"][name]
        assert toks == want, (name, toks, want)
        assert facts["grouped"] == want_facts["grouped"]
        assert facts["preemptions"] == want_facts["preemptions"]
    if WORKLOADS[name][3] == "grouped":
        assert ranks[0]["batchers"][name][1]["grouped"]
    if name.startswith("paged_preemption"):
        assert ranks[0]["batchers"][name][1]["preemptions"] > 0


@pytest.mark.parametrize("name", ["paged_preemption", "paged_preemption_tp4",
                                  "paged_features"])
def test_k11_runs_on_each_ranks_heads(ranks, name):
    """kernel="auto" keeps K11 on a mesh (JAX falls back to its gather
    path there): every decode attention call of a rank is K11's at (B,
    KV/tp, G, hd), once a layer and decode step on every rank."""
    tp = dict(MESHES[WORKLOADS[name][1]])["tp"]
    shapes = {(2, CFG["n_head"] // tp, 1, CFG["d_model"] // CFG["n_head"])}
    for r in ranks:
        facts = r["batchers"][name][1]
        assert facts["kernel"] == "auto"
        assert set(facts["k11_shapes"]) == shapes, facts["k11_shapes"]
        assert facts["decode_steps"] > 0
        assert facts["k11_calls"] == CFG["n_layer"] * facts["decode_steps"]


@pytest.mark.parametrize("name", ["paged_preemption", "paged_preemption_tp4"])
def test_k11_per_rank_is_the_whole_pool_call_sliced(ranks, name):
    """K11's plain version on each rank's pool and heads against one call
    on the tp ranks' pools and heads put together (the single-device
    pool): each rank's result is its heads' slice of the whole call's."""
    from neuronika_tpu_torch.ops.paged_attention import paged_attention

    tp = dict(MESHES[WORKLOADS[name][1]])["tp"]
    first = [r["batchers"][name][1]["k11_first"] for r in ranks[:tp]]
    for t in (3, 4):                   # table and positions: the same
        for f in first[1:]:
            np.testing.assert_array_equal(f[t], first[0][t])
    q, pk, pv = (torch.from_numpy(np.concatenate([f[i] for f in first], 1))
                 for i in range(3))
    whole = paged_attention(q, pk, pv, torch.from_numpy(first[0][3]),
                            torch.from_numpy(first[0][4])).numpy()
    kv = q.shape[1] // tp
    for i, f in enumerate(first):
        np.testing.assert_allclose(f[5], whole[:, i * kv:(i + 1) * kv],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("case, jax_case", [
    ("batcher_no_tp", "no_tp"), ("paged_no_tp", "no_tp"),
    ("generate_no_dp_tp", "no_dp_tp"), ("generate_kv_heads", "kv_heads"),
    ("batcher_kv_heads", "kv_heads"), ("paged_kv_heads", "kv_heads")])
def test_refusals_are_jaxs(ranks, jax_refs, case, jax_case):
    """The three entry points raise JAX's ValueErrors with JAX's words."""
    for r in ranks:
        assert r["refusals"][case] == jax_refs["messages"][jax_case]


def test_ranks_load_no_jax(ranks):
    assert all(r["jax_loaded"] == [] for r in ranks)
