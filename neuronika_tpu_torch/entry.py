"""The port's top-level entry points (counterpart of the JAX package's
`__graft_entry__.py`).

* `entry()` -> (fwd, (params, tokens)): the forward of the flagship model
  (mini GPT-2: vocab 512, 4 layers, 4 heads, d 256, d_ff 1024, S 128,
  bf16) on one device; on the card each layer's attention is one K1
  launch (hd 64, the Hopper route).
* `dryrun_multichip(n)`: every section of JAX's dryrun on n ranks
  (`parallel.mesh.spawn`), with JAX's configurations and checks: the dp x
  tp train step with sequence parallelism (and, when n % 8 == 0, dp x tp x
  ep with the all-to-all MoE), FSDP, GPipe against sequential execution,
  1F1B with the MoE aux loss, the packed-qkv flash op per shard, the cp
  ring against the single-device loss, `make_generate` on dp x tp, the
  paged and the grouped-admission dense batchers on tp 2, and the
  define-by-run tier's fused step on dp-sharded leaves. Each section
  prints one line.

Both run on `config.device` ("cuda") unless the caller asks for the CPU.
On the card with fewer cards than ranks the ranks are gloo processes that
share the cards (rank r on card r % cards), and the output says so; with
a card a rank they are NCCL processes. Nothing falls back to the CPU: a
missing card raises, and a failed section raises with the ranks'
tracebacks.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .config import config
from .device import resolve

__all__ = ["entry", "dryrun_multichip", "Dryrun", "kernel_launches",
           "FLAGSHIP"]

# __graft_entry__.py's flagship, dtype aside (bf16)
FLAGSHIP = dict(vocab_size=512, n_layer=4, n_head=4, d_model=256, d_ff=1024,
                max_seq=128, dropout=0.0)
_PG_TIMEOUT = 300.0          # s a collective may wait
_RUN_LIMIT = 900.0           # s the ranks may take


def entry():
    """(fwd, (params, tokens)): fwd(params, tokens) -> (B, S, V) logits of
    the flagship, params from `torch.Generator` seed 0 on `config.device`,
    tokens zeros (4, 128)."""
    from .models import transformer as T

    dev = resolve(config.device)
    cfg = T.GPTConfig(dtype=torch.bfloat16, **FLAGSHIP)
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)

    def fwd(params, tokens):
        return T.forward(params, tokens, cfg, train=False)

    tokens = torch.zeros((4, cfg.max_seq), dtype=torch.int32, device=dev)
    return fwd, (params, tokens)


# --------------------------------------------------------------------------
# dryrun_multichip: the ranks' side


def _finite(x: float, what: str) -> float:
    if not (x == x and abs(x) < 1e9):
        raise AssertionError(f"non-finite {what} {x}")
    return x


class _Ctx:
    """What every section needs on a rank."""

    def __init__(self, n: int, dev: torch.device) -> None:
        from . import parallel as P
        from .models import transformer as T

        self.n, self.dev, self.P, self.T = n, dev, P, T

    def params(self, cfg, seed: int = 0):
        return self.T.init_params(
            torch.Generator(device=self.dev).manual_seed(seed), cfg,
            self.dev)

    def cfg(self, **kw):
        base = dict(vocab_size=64, n_layer=2, n_head=4, d_model=64,
                    d_ff=128, max_seq=32, dropout=0.0, dtype=torch.float32)
        base.update(kw)
        return self.T.GPTConfig(**base)

    def batch(self, B: int, S: int):
        return (torch.zeros((B, S), dtype=torch.int32, device=self.dev),
                torch.ones((B, S), dtype=torch.int32, device=self.dev))


def _sec_step(c: _Ctx) -> str:
    """The dp x tp step with seq_parallel; dp x tp x ep with the
    expert-parallel MoE when n % 8 == 0."""
    n, n_experts = c.n, 0
    if n % 8 == 0:
        axes, n_experts = [("dp", n // 4), ("tp", 2), ("ep", 2)], 4
    else:
        tp = next((t for t in (4, 2) if n % t == 0), 1)
        axes = [("dp", n // tp), ("tp", tp)]
    cfg = c.cfg(n_experts=n_experts, seq_parallel=True,
                moe_impl="ep" if n_experts else "dense")
    mesh = c.P.make_mesh(axes)
    params = c.params(cfg)
    step = c.T.make_sharded_train_step(mesh, cfg)
    tokens, targets = c.batch(max(dict(axes)["dp"], 2), 32)
    _, _, loss = step(params, c.T.opt_init(params, cfg), tokens, targets,
                      1e-3)
    loss = _finite(float(loss), "loss")
    desc = " ".join(f"{a}={s}" for a, s in axes)
    moe = f" moe(E={n_experts},ep-a2a)" if n_experts else ""
    return f"dryrun_multichip ok: mesh {desc} sp=on{moe}, loss={loss:.4f}"


def _sec_fsdp(c: _Ctx) -> str:
    """ZeRO-3: params and Adam moments stored at 1/dp a rank (qkv also
    split over tp where the mesh has it)."""
    tp = next((t for t in (4, 2) if c.n % t == 0), 1)
    mesh = c.P.make_mesh([("dp", c.n // tp), ("tp", tp)])
    cfg = c.cfg(flash="off")
    params = c.params(cfg)
    step = c.T.make_sharded_train_step(mesh, cfg, fsdp=True,
                                       fsdp_min_size=0)
    tokens, targets = c.batch(max(c.n // tp, 2), 32)
    zp, _, loss = step(params, c.T.opt_init(params, cfg), tokens, targets,
                       1e-3)
    loss = _finite(float(loss), "fsdp loss")
    qkv = zp["blocks"]["qkv"]
    ratio = qkv.numel() // qkv.to_local().numel()
    if ratio <= 1:
        raise AssertionError("fsdp left qkv unsharded")
    return (f"dryrun fsdp ok: ZeRO-3 step, qkv stored 1/{ratio} per chip, "
            f"loss={loss:.4f}")


def _stages(n: int) -> int:
    return 4 if n % 4 == 0 else 2


def _sec_gpipe(c: _Ctx) -> str:
    """GPipe over a pp axis (each dp group runs the same pipeline) against
    the blocks run in sequence."""
    from .parallel.pipeline import pipeline_forward

    T, stages = c.T, _stages(c.n)
    cfg = c.cfg(n_layer=stages, flash="off")
    params = c.params(cfg)
    mesh = c.P.make_mesh([("dp", c.n // stages), ("pp", stages)])

    def stage_fn(blk, x):
        return T._block(x, blk, cfg, False, None)[0]

    micro = torch.randn((4, 2, 32, 64),
                        generator=torch.Generator(device=c.dev).manual_seed(1),
                        device=c.dev)
    with torch.no_grad():
        out = pipeline_forward(stage_fn, mesh)(params["blocks"], micro)
        ref = micro.reshape(8, 32, 64)
        for i in range(stages):
            ref = stage_fn(T._layer(params["blocks"], i), ref)
    err = float((out.reshape(8, 32, 64) - ref).abs().max())
    if not err < 1e-4:
        raise AssertionError(f"pipeline mismatch {err}")
    return f"dryrun pp ok: {stages} stages, max err {err:.2e}"


def _sec_1f1b(c: _Ctx) -> str:
    """The 1F1B train step (forward, backward, Adam) with the MoE aux
    loss."""
    stages = _stages(c.n)
    cfg = c.cfg(n_layer=stages, flash="off", n_experts=2,
                moe_aux_weight=0.01)
    mesh = c.P.make_mesh([("dp", c.n // stages), ("pp", stages)])
    step, reshape = c.T.make_pipelined_train_step_1f1b(mesh, cfg, n_micro=4)
    staged = reshape(c.params(cfg))
    tokens, targets = c.batch(8, 32)
    _, _, loss = step(staged, c.T.opt_init(staged, cfg), tokens, targets,
                      1e-3)
    loss = _finite(float(loss), "1f1b loss")
    return f"dryrun pp-1f1b ok: {stages} stages, moe aux on, loss={loss:.4f}"


def _sec_packed_flash(c: _Ctx) -> str:
    """The packed-qkv flash op per shard on dp x tp 2: each rank's call
    (K1 and the fused K2 on the card) sees its local heads."""
    from .ops import flash_attention as FA

    T = c.T
    cfg = c.cfg(n_layer=1, n_head=2, d_model=256, d_ff=256, max_seq=128,
                flash="on", flash_bwd="fused")
    dp = c.n // 2
    mesh = c.P.make_mesh([("dp", dp), ("tp", 2)])
    calls, real = [], T.flash_attention_qkv

    def spy(qkv, n_head, *a, **kw):
        calls.append((tuple(qkv.shape), n_head))
        return real(qkv, n_head, *a, **kw)

    k1 = FA.flash_fwd_qkv.launches
    T.flash_attention_qkv = spy
    try:
        params = c.params(cfg)
        step = T.make_sharded_train_step(mesh, cfg)
        tokens, targets = c.batch(2 * dp, 128)
        _, _, loss = step(params, T.opt_init(params, cfg), tokens, targets,
                          1e-3)
        loss = _finite(float(loss), "packed-flash loss")
    finally:
        T.flash_attention_qkv = real
    k1 = FA.flash_fwd_qkv.launches - k1
    if not calls or calls[0][1] != 1:
        raise AssertionError(f"packed flash calls {calls}")
    if c.dev.type == "cuda" and k1 < 1:
        raise AssertionError("no K1 launch in the sharded flash step")
    launched = f", K1 launches {k1} a rank" if c.dev.type == "cuda" else ""
    return ("dryrun packed-qkv flash ok: flash_attention_qkv per-shard "
            f"(local qkv {calls[0][0]}, local heads {calls[0][1]}"
            f"{launched}), loss={loss:.4f}")


def _sec_cp(c: _Ctx) -> str:
    """The S-sharded step with ring attention over cp 2 against the
    single-device step."""
    T = c.T
    cfg = c.cfg(max_seq=64, flash="on", flash_block=64)
    dp = c.n // 2
    mesh = c.P.make_mesh([("dp", dp), ("cp", 2)])
    tokens, targets = c.batch(2 * dp, 64)
    params = c.params(cfg)
    _, _, cl = T.make_sharded_train_step(mesh, cfg)(
        params, T.opt_init(params, cfg), tokens, targets, 1e-3)
    params = c.params(cfg)
    _, _, ul = T.make_train_step(cfg)(params, T.opt_init(params, cfg),
                                      tokens, targets, 1e-3)
    cl, ul = float(cl), float(ul)
    if not abs(cl - ul) < 1e-4:
        raise AssertionError(f"cp loss diverged: {cl} vs {ul}")
    return (f"dryrun cp ring-attention ok: dp{dp}xcp2 S-sharded step == "
            f"single-chip (loss {cl:.4f})")


def _sec_generate(c: _Ctx) -> str:
    """make_generate on dp x tp 2: the single-device greedy tokens."""
    T = c.T
    cfg = c.cfg(max_seq=64, flash="off")
    dp = c.n // 2
    mesh = c.P.make_mesh([("dp", dp), ("tp", 2)])
    params = c.params(cfg)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (2 * dp, 8)).astype(np.int32)).to(c.dev)
    toks_s = T.make_generate(cfg, max_new=8, mesh=mesh)(params, prompt)
    toks_1 = T.make_generate(cfg, max_new=8)(params, prompt)
    if not torch.equal(toks_s, toks_1):
        raise AssertionError("sharded generate diverged")
    return (f"dryrun tp-serving ok: dp{dp}xtp2 make_generate == "
            f"single-chip ({toks_s.shape[1] - 8} new tokens, greedy "
            "identical)")


_PROMPTS = ([1, 2, 3, 4], [7, 8], [9, 10, 11, 12, 13, 14])


def _batcher_parts(c: _Ctx):
    cfg = c.cfg(max_seq=48, flash="off")
    mesh = c.P.make_mesh([("dp", c.n // 2), ("tp", 2)])
    return cfg, mesh, c.params(cfg), [np.array(p, np.int32)
                                      for p in _PROMPTS]


def _sec_paged(c: _Ctx) -> str:
    """The paged batcher (preemption, multi-step windows) tp-sharded
    against the single-device batcher: the same tokens."""
    from .serving import PagedBatcher

    cfg, mesh, params, prompts = _batcher_parts(c)

    def serve(m):
        pb = PagedBatcher(params, cfg, n_slots=2, n_blocks=5, block_size=4,
                          mesh=m, device=c.dev)
        rids = [pb.submit(p, k) for p, k in zip(prompts, (10, 4, 7))]
        done = pb.run(multi_step=4)
        return [done[r].tolist() for r in rids], pb.preemptions

    ref, _ = serve(None)
    got, n_pre = serve(mesh)
    if got != ref:
        raise AssertionError(f"paged batcher on the mesh: {got} vs {ref}")
    return ("dryrun batcher-on-mesh ok: tp2 PagedBatcher == single-chip "
            f"(3 reqs, multi-step windows, {n_pre} preemption(s), "
            "token-identical)")


def _sec_grouped(c: _Ctx) -> str:
    """The dense batcher's grouped admission (a deferred burst prefilled
    as one multi-row group) tp-sharded against the single-device run."""
    from .serving import ContinuousBatcher

    cfg, mesh, params, prompts = _batcher_parts(c)

    def serve(m):
        cb = ContinuousBatcher(params, cfg, n_slots=3, mesh=m,
                               prefill_bucket="pow2", device=c.dev)
        with cb.defer_admission():
            rids = [cb.submit(p, 6, temperature=0.5, seed=i)
                    for i, p in enumerate(prompts)]
        done = cb.run(multi_step=4)
        return [done[r].tolist() for r in rids], cb._multi_prefill is not None

    ref, _ = serve(None)
    got, grouped = serve(mesh)
    if not grouped:
        raise AssertionError("grouped admission did not engage")
    if got != ref:
        raise AssertionError(f"grouped admission on the mesh: {got} vs "
                             f"{ref}")
    return ("dryrun grouped-admission ok: tp2 ContinuousBatcher deferred "
            "burst == single-chip (multi-row prefill, token-identical)")


def _sec_var(c: _Ctx) -> str:
    """The define-by-run tier: MLP((8, 16, 4)) with SGD(0.05, L2(1e-4)),
    two fused steps on x sharded over dp = n."""
    import neuronika_tpu_torch as nk
    from . import models, optim

    nk.seed(0)
    mesh = c.P.make_mesh([("dp", c.n)])
    mlp = models.MLP((8, 16, 4))
    opt = optim.SGD(0.05, optim.L2(1e-4))
    opt.register_all(mlp.parameters())
    rng = np.random.default_rng(0)
    Xn = rng.random((4 * c.n, 8), dtype=np.float32)
    Yn = rng.random((4 * c.n, 4), dtype=np.float32)
    losses = []
    for _ in range(2):
        x = nk.from_ndarray(Xn)
        x.node.value = c.P.shard_batch(x.node.value, mesh)
        loss = mlp.forward(x).mse(nk.from_ndarray(Yn), nk.Reduction.Mean)
        losses.append(_finite(opt.train_step(loss, block=True), "Var loss"))
    if not losses[1] < losses[0]:
        raise AssertionError(f"Var losses {losses}")
    return (f"dryrun define-by-run dp ok: fused Var step, dp={c.n} sharded "
            f"leaves, loss {losses[0]:.4f} -> {losses[1]:.4f}")


def _sections(n: int):
    secs = [_sec_step, _sec_fsdp]
    if n >= 2:
        secs += [_sec_gpipe, _sec_1f1b]
    if n >= 4:
        secs += [_sec_packed_flash, _sec_cp, _sec_generate]
    if n >= 2:
        secs += [_sec_paged, _sec_grouped]
    return secs + [_sec_var]


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count, by the wrapper's name."""
    from .ops import flash_attention as FA
    from .ops import matmul, paged_attention, softmax

    fns = (*FA.KERNELS, *FA.SPLIT_KERNELS, matmul.matmul,
           softmax.softmax_last_axis, paged_attention.paged_attention)
    return {f.__name__: f.launches for f in fns}


def _dryrun_rank(rank: int, n: int, dev_type: str, cards: int) -> dict:
    import neuronika_tpu_torch as nk

    nk.config.device = dev_type
    if dev_type == "cuda":
        from ._build import load_library

        torch.cuda.set_device(rank % cards)
        load_library()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    c = _Ctx(n, torch.device(dev_type, torch.cuda.current_device())
             if dev_type == "cuda" else torch.device("cpu"))
    lines = [sec(c) for sec in _sections(n)]
    return {"lines": lines, "launches": kernel_launches()}


class Dryrun(NamedTuple):
    """What `dryrun_multichip` ran: the printed lines, and the kernels'
    launches summed over the ranks (by wrapper name)."""
    lines: List[str]
    launches: Dict[str, int]


def dryrun_multichip(n_devices: int, device=None) -> Dryrun:
    """Run every section on `n_devices` ranks on `device` (default
    `config.device`); print rank 0's lines, after one line that says how
    the ranks were placed."""
    from .parallel.mesh import spawn

    n = int(n_devices)
    if n < 1 or (n > 1 and n % 2):
        raise ValueError(f"dryrun_multichip runs 1 or an even number of "
                         f"ranks, not {n}")
    dev = resolve(device if device is not None else config.device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= n else "gloo"
        where = (f"NCCL, one of {cards} card(s) a rank" if backend == "nccl"
                 else f"gloo ranks sharing {cards} card(s)")
    else:
        cards, backend, where = 0, "gloo", "gloo on the CPU"
    with tempfile.TemporaryDirectory() as tmp:
        res = spawn(_dryrun_rank, n, (n, dev.type, cards),
                    init_file=os.path.join(tmp, "store"), backend=backend,
                    timeout=_PG_TIMEOUT, limit=_RUN_LIMIT)
    lines = [f"dryrun_multichip: {n} ranks, {where}"] + res[0]["lines"]
    for line in lines:
        print(line, flush=True)
    return Dryrun(lines, {k: sum(r["launches"][k] for r in res)
                          for k in res[0]["launches"]})
