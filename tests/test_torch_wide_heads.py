"""The attention paths of the port at the head dims and group sizes that
JAX's kernels take beyond the headline's (hd 64 and 128 with at most 8
query heads per kv head): the GPT loss and its gradients against JAX's
`loss_fn` with flash "on" in both packages (JAX's K1/K2 or K5-K7 in
interpret mode, the port's plain versions on the CPU) at hd 80 and 96
with rotary positions and a window, and at groups of 12, 16 (MQA) and 32
with learned positions; PagedBatcher's greedy tokens against JAX's at hd
96 and G 16; the gates that send these shapes to the kernels on the card
(`kernels_take`, `_sm90_route`, `_use_flash`, `_attn_use_kernel`, the
paged kernel's checks) and refuse a head dim above 256 under "on"; and
the cluster plans of K2b and the fused K2 past 8 query heads a kv head
(`dkv_plan`, `fused_plan`). f32; params from the JAX tree, tokens from
numpy."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu import serving as JS
from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch import serving as TS
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.ops import flash_attention as FA
from neuronika_tpu_torch.ops import functional as TF
from neuronika_tpu_torch.ops import paged_attention as PA
from tests.conftest import TOL
from tests.test_torch_llama import _prompts, interpret  # noqa: F401
from tests.test_torch_train import (GRAD_TOL, _batch, _params, _port_grads,
                                    _tree_err)

# (preset, fields): hd 80 and 96 under rope and a window of 16 < S (the
# split op, K5-K7), G 16, 12 (hd 64) and 32 (hd 128, one layer) under
# learned positions (the packed op, K1/K2; on the card the Hopper route's
# hd at G 12 and 32)
WIDE = {
    "rope-hd80-window": ("llama", dict(n_head=2, n_kv_head=1, d_model=160,
                                       window=16)),
    "rope-hd96-window": ("llama", dict(n_head=2, d_model=192, window=16)),
    "learned-g16-mqa": ("gpt", dict(n_head=16, n_kv_head=1, d_model=256)),
    "learned-g12-hd64": ("gpt", dict(n_head=12, n_kv_head=1, d_model=768)),
    "learned-g32-hd128": ("gpt", dict(n_head=32, n_kv_head=1, d_model=4096,
                                      n_layer=1)),
}
BASE = dict(vocab_size=96, n_layer=2, d_ff=192, max_seq=64, flash_block=16)


def _cfgs(name, **kw):
    preset, fields = WIDE[name]
    fields = {**BASE, **fields, **kw}
    if preset == "llama":
        return (JT.llama_config(dtype=jnp.float32, **fields),
                TT.llama_config(dtype=torch.float32, **fields))
    return (JT.GPTConfig(dtype=jnp.float32, **fields),
            TT.GPTConfig(dtype=torch.float32, **fields))


@pytest.mark.parametrize("name", list(WIDE))
def test_loss_and_grads_match_jax_flash_on(name, interpret):
    """flash="on" in both packages: the loss and every gradient, with
    remat, against JAX's Pallas kernels in interpret mode."""
    jcfg, tcfg = _cfgs(name, flash="on")
    jp, tp = _params(jcfg)
    toks, tgts = _batch(jcfg, S=64)
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg, train=True)
    loss, grads = _port_grads(tp, tcfg, toks, tgts)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert _tree_err(grads, jgrads) <= GRAD_TOL


@pytest.mark.parametrize("name", ["rope-hd96-window", "learned-g16-mqa"])
def test_paged_batcher_greedy_tokens_match_jax(name):
    """The port's PagedBatcher (the paged kernel's plain version) gives
    JAX's greedy tokens (JAX's gather path) at hd 96 and at G 16."""
    jcfg, tcfg = _cfgs(name, flash="off", window=6 if "window" in name
                       else 0)
    jp, tp = _params(jcfg, seed=2)
    prompts, max_news = _prompts()
    pool = dict(n_slots=2, n_blocks=16, block_size=8)
    jb = JS.PagedBatcher(jp, jcfg, kernel="off", **pool)
    jr = [jb.submit(p, m) for p, m in zip(prompts, max_news)]
    jout = jb.run()
    tb = TS.PagedBatcher(tp, tcfg, kernel="auto", device="cpu", **pool)
    tr = [tb.submit(p, m) for p, m in zip(prompts, max_news)]
    tout = tb.run()
    for a, b, m in zip(jr, tr, max_news):
        assert tout[b].shape == (m,)
        np.testing.assert_array_equal(tout[b], jout[a])


def _on_card(dtype, *shape):
    """Stands for a CUDA tensor where a gate reads only device, dtype and
    shape: the gates decide without a card."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 shape=shape)


@pytest.mark.parametrize("hd", [8, 36, 72, 80, 96, 128, 256])
@pytest.mark.parametrize("G", [1, 3, 16])
def test_gates_send_every_head_dim_and_group_to_the_kernels(hd, G):
    """f32 and bf16 at hd 8-256 and any G: the model's flash gate, the Var
    op's and the paged kernel's checks all take the shape; bf16 at hd
    64/128 runs the Hopper K1, K2a, K2b and fused K2 at any G, K2b and the
    fused K2 past G 8 on a cluster."""
    for dtype in (torch.float32, torch.bfloat16):
        assert FA.kernels_take(dtype, hd)
        hopper = dtype == torch.bfloat16 and hd in (64, 128)
        assert FA._sm90_route(dtype, hd) == hopper
        clusters = {FA.dkv_cluster(8, 1, 2048, G),
                    FA.fused_cluster(8, 1, 2048, G)}
        assert clusters == ({1} if G <= 8 else {4})
        cfg = TT.GPTConfig(n_head=G * 2, n_kv_head=2, d_model=G * 2 * hd,
                           dtype=dtype, flash="on")
        assert TT._use_flash(cfg, _on_card(dtype))
        W = (2 * G + 4) * hd
        assert TF._attn_use_kernel(_on_card(dtype, 1, 4, W), 2 * G, 2, 0.0)
    q = torch.zeros(2, 2, G, hd)
    pool = torch.zeros(5, 2, 8, hd)
    PA._check(q, pool, pool, torch.zeros(2, 2, dtype=torch.int32),
              torch.zeros(2, dtype=torch.int32), 0)


def test_gates_refuse_above_256_and_f16():
    """hd 320 and f16: "on" raises naming the ROADMAP item, "auto" takes
    the composite, the Var op and the paged kernel refuse."""
    for dtype, hd in ((torch.bfloat16, 320), (torch.float16, 64)):
        assert not FA.kernels_take(dtype, hd)
        cfg = TT.GPTConfig(n_head=2, d_model=2 * hd, dtype=dtype, flash="on")
        with pytest.raises(NotImplementedError, match="queue 1 item 3"):
            TT._use_flash(cfg, _on_card(dtype))
        cfg = TT.GPTConfig(n_head=2, d_model=2 * hd, dtype=dtype)
        assert not TT._use_flash(cfg, _on_card(dtype))
        assert not TF._attn_use_kernel(_on_card(dtype, 1, 4, 6 * hd), 2, 0,
                                       0.0)
    q = torch.zeros(2, 1, 1, 320)
    pool = torch.zeros(5, 1, 8, 320)
    with pytest.raises(ValueError, match="head dim 320"):
        PA._check(q, pool, pool, torch.zeros(2, 2, dtype=torch.int32),
                  torch.zeros(2, dtype=torch.int32), 0)
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        FA._kernel_dtype_and_hd(torch.float32, 320)
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        FA._kernel_dtype_and_hd(torch.float16, 64)


@pytest.mark.parametrize("G", [1, 8, 9, 16, 32])
def test_paged_group_chunks_and_split_reference(G):
    """A group of G query heads runs as ceil(G / 8) CTAs over a kv head;
    the split-and-merge twin of the kernel's math, planned over those
    CTAs, agrees with the gather reference at hd 96 (f32)."""
    assert PA.group_chunks(G) == -(-G // 8)
    rng = np.random.default_rng(G)
    B, KV, hd, BS, MB = 3, 2, 96, 8, 16
    q = torch.from_numpy(rng.standard_normal((B, KV, G, hd), np.float32))
    pk, pv = (torch.from_numpy(rng.standard_normal((B * MB, KV, BS, hd),
                                                   np.float32))
              for _ in range(2))
    table = torch.from_numpy(rng.permutation(B * MB).reshape(B, MB).astype(
        np.int32))
    pos = torch.tensor([5, 127, 60], dtype=torch.int32)
    for window in (0, 9):
        want = PA.paged_attention_reference(q, pk, pv, table, pos,
                                            window=window)
        got = PA.paged_attention_split_reference(q, pk, pv, table, pos,
                                                 window=window, bps=3)
        assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("G", [9, 12, 16, 32, 64])
@pytest.mark.parametrize("B, KV, S", [(8, 1, 2048), (2, 1, 384),
                                      (2, 2, 257), (1, 4, 4096),
                                      (16, 1, 8192)])
def test_dkv_cluster_plan_covers_every_head_once(G, B, KV, S):
    """K2b's plan past 8 query heads a kv head: a cluster of 2, 4 or 8
    CTAs an item, the least whose CTAs fill two waves of an H100's 132
    SMs where one does (else 8); the items k-tile-major, each (k tile, b,
    kv head) once; the ranks' heads contiguous chunks in head order,
    together every head of the group once, none empty."""
    C, items = FA.dkv_plan(B, KV, S, G)
    n_kt = -(-S // 128)
    assert C in (2, 4, 8)
    assert len(items) == n_kt * B * KV
    if len(items) * 8 >= 2 * 132:
        assert len(items) * C >= 2 * 132
        assert C == 2 or len(items) * (C // 2) < 2 * 132
    else:
        assert C == 8
    assert [it[:3] for it in items] == [(kt, b, g) for kt in range(n_kt)
                                        for b in range(B) for g in range(KV)]
    seen = np.zeros((n_kt, B, KV, G), np.int64)
    for kt, b, g, heads in items:
        assert len(heads) == C
        assert heads[0][0] == 0 and heads[-1][1] == G
        for (h0, h1), (n0, _) in zip(heads, heads[1:] + ((G, G),)):
            assert 0 <= h0 < h1 == n0
        for h0, h1 in heads:
            seen[kt, b, g, h0:h1] += 1
    assert (seen == 1).all()
    # up to 8 query heads a kv head the walk keeps one CTA an item
    assert FA.dkv_cluster(B, KV, S, 8) == FA.dkv_cluster(B, KV, S, 1) == 1
    # StarCoderBase-1B's shape (B8 S2048, one kv head, G 16): 128 items
    # on clusters of 4, 512 CTAs
    assert FA.dkv_cluster(8, 1, 2048, 16) == 4


FUSED_SHAPES = [(8, 1, 2048, True), (2, 1, 384, False), (2, 2, 257, True),
                (1, 4, 4096, True), (3, 1, 100, False)]


@pytest.mark.parametrize("G", [1, 8, 9, 12, 16, 32])
@pytest.mark.parametrize("B, KV, S, causal", FUSED_SHAPES)
def test_fused_plan_shares_every_group(G, B, KV, S, causal):
    """The fused K2's plan: C 1 up to 8 query heads a kv head, past that 2,
    4 or 8 and at most G; every (k tile, b, kv head) once, (b, g)-major;
    the ranks' heads contiguous shares that partition the group, each
    walking the item's band of q tiles (from the diagonal's tile under a
    causal mask) once a head, from the last."""
    C, items, _ = FA.fused_plan(B, KV, S, G, causal)
    n_kt, n_qt = -(-S // 128), -(-S // 64)
    if G <= 8:
        assert C == 1
    else:
        assert C in (2, 4, 8) and C <= G
    assert C == FA.fused_cluster(B, KV, S, G)
    assert [it[:3] for it in items] == [(kt, b, g) for b in range(B)
                                        for g in range(KV)
                                        for kt in range(n_kt)]
    for kt, _, _, walks in items:
        assert len(walks) == C
        qts = list(range(2 * kt if causal else 0, n_qt))
        shares = [sorted({m for m, _ in w}) for w in walks]
        assert [m for share in shares for m in share] == list(range(G))
        for w, share in zip(walks, shares):
            assert share and share == list(range(share[0], share[-1] + 1))
            assert sorted(w) == [(m, qt) for m in share for qt in qts]
            for m in share:    # each head's q tiles from the last down
                assert [qt for mm, qt in w if mm == m] == qts[::-1]


@pytest.mark.parametrize("G", [1, 8, 9, 16, 32])
@pytest.mark.parametrize("B, KV, S, causal", FUSED_SHAPES)
def test_fused_plan_chains_dq_in_k_tile_order(G, B, KV, S, causal):
    """Every (b, q head, q tile) gets its dq terms from k tiles 0 .. n - 1,
    each from one CTA, in the order of the kernel's item index (the turn
    counter of kt 0 stores, each later kt adds after the one before); past
    8 query heads a kv head the walks are q-tile-major, so a (head, q
    tile) is the same step of every item's walk that holds it (each walk
    starts at the last q tile)."""
    C, items, _ = FA.fused_plan(B, KV, S, G, causal)
    terms, step = {}, {}
    for i, (kt, b, g, walks) in enumerate(items):
        for r, w in enumerate(walks):
            for n, (m, qt) in enumerate(w):
                terms.setdefault((b, g * G + m, qt), []).append((i, kt, r))
                step.setdefault((b, g, r, m, qt), set()).add(n)
    n_qt = -(-S // 64)
    assert len(terms) == B * KV * G * n_qt
    for (b, h, qt), got in terms.items():
        kts = [kt for _, kt, _ in got]
        assert kts == list(range(len(kts)))
        assert [i for i, _, _ in got] == sorted(i for i, _, _ in got)
        assert len(kts) == (min(qt // 2 + 1, -(-S // 128)) if causal
                            else -(-S // 128))
        assert len({r for _, _, r in got}) == 1     # the same rank each
    if C > 1:
        assert all(len(s) == 1 for s in step.values())


@pytest.mark.parametrize("clusters", [1, 2, 5, 16, 32, 33, 66, 200])
@pytest.mark.parametrize("G", [8, 16])
def test_fused_deal_runs_every_item_in_order(clusters, G):
    """The deal of items to the resident CTAs (G 8, round robin) or
    clusters (G 16, forth and back): each takes its items in increasing
    order, every item once; and a schedule in which an item starts only
    once the item before it in its (b, g) chain has finished, each
    cluster running its items in turn, runs them all (no deadlock)."""
    B, KV, S = 8, 1, 2048
    C, items, deal = FA.fused_plan(B, KV, S, G, clusters=clusters)
    assert len(deal) == clusters
    assert sorted(i for d in deal for i in d) == list(range(len(items)))
    assert all(d == sorted(d) for d in deal)
    if C == 1:
        assert all(d == list(range(c, len(items), clusters))
                   for c, d in enumerate(deal))
    done, pos = set(), [0] * clusters
    while True:
        moved = False
        for c, d in enumerate(deal):
            if pos[c] < len(d):
                i = d[pos[c]]
                kt, b, g, _ = items[i]
                if kt == 0 or (b, g, kt - 1) in done:
                    done.add((b, g, kt))
                    pos[c] += 1
                    moved = True
        if not moved:
            break
    assert len(done) == len(items)
    # forth and back: at StarCoderBase-1B's shape on 32 clusters of 4 the
    # clusters' causal walks (q tiles summed over their items) are level
    if C > 1 and clusters == 32:
        work = [sum(len(items[i][3][0]) for i in d) for d in deal]
        assert max(work) == min(work)
