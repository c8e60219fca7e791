"""Serving walkthrough: one-shot generation, quantization, continuous
batching, a throughput burst and tensor-parallel serving (twin of the JAX
package's `examples/serving.py`: the same tiny model, d128 L2 H4 V256,
f32, random weights from a seed).

    python -m neuronika_tpu_torch.examples.serving

Tensor-parallel serving runs on a mesh of torch.distributed ranks: on the
CPU, dp1 x tp2 on two spawned gloo ranks; on the card, a one-rank NCCL
group (dp1 x tp1; with more cards, launch one process a card under
torchrun and build the mesh with `parallel.make_mesh`).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from neuronika_tpu_torch import parallel as P
from neuronika_tpu_torch.config import config
from neuronika_tpu_torch.device import resolve
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.serving import ContinuousBatcher

CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=128, d_ff=512,
           max_seq=128, dtype=torch.float32)


def _model(dev, seed):
    cfg = T.GPTConfig(**CFG)
    return cfg, T.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                              dev)


def _tp_greedy(axes, seed, prompt, dev):
    """Greedy make_generate(mesh=) on this rank's slice of the model:
    every rank returns the whole tokens."""
    cfg, params = _model(dev, seed)
    gen = T.make_generate(cfg, max_new=16, mesh=P.make_mesh(axes))
    return gen(params, torch.as_tensor(prompt, device=dev)).cpu().numpy()


def _cpu_rank(rank, axes, seed, prompt):
    config.device = "cpu"          # the mesh's device type: gloo's
    return _tp_greedy(axes, seed, prompt, torch.device("cpu"))


def tp_serving(dev, seed, prompt) -> np.ndarray:
    """The JAX example's mesh block: greedy tokens served tensor-parallel,
    dp1 x tp2 on two spawned gloo ranks on the CPU, dp1 x tp1 on a
    one-rank NCCL group on the card."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        if dev.type == "cpu":
            return P.mesh.spawn(_cpu_rank, 2,
                                ([("dp", 1), ("tp", 2)], seed, prompt),
                                init_file=store, timeout=60.0,
                                limit=120.0)[0]
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1)
        try:
            return _tp_greedy([("dp", 1), ("tp", 1)], seed, prompt, dev)
        finally:
            dist.destroy_process_group()


def main(device=None, seed: int = 0, verbose: bool = True):
    """Run the walkthrough on `device` (default `config.device`); returns
    a dict with each part's tokens."""
    dev = resolve(config.device if device is None else device)
    cfg, params = _model(dev, seed)

    # one-shot: a batched prefill and the decode steps, on the device
    gen = T.make_generate(cfg, max_new=16, temperature=0.8, top_k=40,
                          quant="int8")
    prompt = torch.tensor([[10, 11, 12, 13]], dtype=torch.int32, device=dev)
    one_shot = gen(params, prompt,
                   torch.Generator(dev).manual_seed(1)).cpu().numpy()
    if verbose:
        print("one-shot int8 sample:", one_shot[0].tolist())

    # continuous batching: requests of different lengths share a slot
    # pool; a finished slot is reassigned at once
    cb = ContinuousBatcher(params, cfg, n_slots=2, device=dev)
    rids = [cb.submit(np.array([1, 2, 3], np.int32), max_new=8),
            cb.submit(np.array([4, 5], np.int32), max_new=12),
            cb.submit(np.array([6], np.int32), max_new=4)]  # queued behind 2
    done = cb.run()
    if verbose:
        for rid in rids:
            print(f"request {rid}: {done[rid].tolist()}")

    # throughput mode: a deferred burst admits same-bucket prompts in ONE
    # multi-row prefill, and multi-step windows decode k tokens per host
    # read; the tokens are those of the per-step path
    cb2 = ContinuousBatcher(params, cfg, n_slots=4, device=dev,
                            prefill_bucket="pow2")
    with cb2.defer_admission():
        burst = [cb2.submit(np.arange(1, 4 + i, dtype=np.int32), max_new=8)
                 for i in range(6)]
    done2 = cb2.run(multi_step=8)
    if verbose:
        print("burst of 6 over 4 slots:",
              {r: done2[r].tolist()[:4] for r in burst[:2]}, "...")

    # tensor-parallel serving: each rank holds its kv heads' slice of the
    # weights and cache; the greedy tokens are the one-device program's
    tp = tp_serving(dev, seed, prompt.cpu().numpy())
    greedy = T.make_generate(cfg, max_new=16)(params, prompt).cpu().numpy()
    if verbose:
        print("tp serving greedy:", tp[0].tolist())
    return {"one_shot": one_shot, "batched": [done[r] for r in rids],
            "burst": [done2[r] for r in burst], "tp": tp, "greedy": greedy}


if __name__ == "__main__":
    main()
