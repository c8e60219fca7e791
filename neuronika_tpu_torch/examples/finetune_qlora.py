"""Fine-tune with QLoRA, then serve the tuned model (twin of the JAX
package's `examples/finetune_qlora.py`).

1. a base model: as in the JAX example, a small random-init Hugging Face
   GPT-2 (d64 L2, a 256-token vocabulary) converted by
   `utils.hf.from_huggingface` when `transformers` is installed, else a
   random GPT of the same widths;
2. the frozen base quantized to int4 (`lora.qlora_quantize_base`) and
   rank-8 adapters attached (`lora.lora_init`);
3. the adapters alone fine-tuned (`lora.make_qlora_train_step`) on a toy
   pattern (each byte b answered by b + 1), logged by `MetricsLogger`;
4. the tuned model merged (`lora.qlora_merge`) and served by the dense-
   slot `ContinuousBatcher`, greedy and sampled per request.

    python -m neuronika_tpu_torch.examples.finetune_qlora
"""

from __future__ import annotations

import numpy as np
import torch

from neuronika_tpu_torch.config import config
from neuronika_tpu_torch.device import resolve
from neuronika_tpu_torch.models import lora as LR
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.serving import ContinuousBatcher
from neuronika_tpu_torch.utils.hf import from_huggingface
from neuronika_tpu_torch.utils.metrics import MetricsLogger


def main(device=None, steps: int = 50, verbose: bool = True):
    """Run the example on `device` (default `config.device`); returns a
    dict with the losses and the served tokens."""
    dev = resolve(config.device if device is None else device)
    # 1. the base
    try:
        import transformers

        torch.manual_seed(0)
        hf_model = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
            n_head=4)).eval()
        params, cfg = from_huggingface(hf_model, dtype=torch.float32,
                                       device=dev)
        if verbose:
            print(f"imported GPT-2: L={cfg.n_layer} d={cfg.d_model} "
                  f"V={cfg.vocab_size}")
    except ImportError:   # transformers not installed: a random base
        cfg = T.GPTConfig(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                          d_ff=256, max_seq=64, dtype=torch.float32)
        params = T.init_params(torch.Generator(dev).manual_seed(0), cfg,
                               dev)

    # 2. int4 base and adapters
    qbase = LR.qlora_quantize_base(params)
    adapters = LR.lora_init(torch.Generator(dev).manual_seed(1), params,
                            rank=8)
    if verbose:
        print(f"adapter params: {LR.lora_param_count(adapters):,} (base "
              f"frozen at int4)")

    # 3. fine-tune on the toy pattern
    step = LR.make_qlora_train_step(cfg, grad_clip=1.0)
    opt = T.adam_init(adapters)
    rng = np.random.default_rng(0)
    B, S = 8, 32
    lr = torch.tensor(3e-3)
    losses = []
    with MetricsLogger(print_every=10 if verbose else 0,
                       tokens_per_step=B * S) as m:
        for i in range(steps):
            x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            y = (x + 1) % cfg.vocab_size
            adapters, opt, loss = step(
                qbase, adapters, opt, torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev), lr)
            m.log(i, loss=loss)
            losses.append(float(loss))

    # 4. merge and serve with per-request sampling
    tuned = LR.qlora_merge(qbase, adapters, dtype=torch.float32)
    cb = ContinuousBatcher(tuned, cfg, n_slots=2, device=dev)
    prompt = np.arange(10, 16, dtype=np.int32)
    greedy = cb.submit(prompt, 8)
    sampled = cb.submit(prompt, 8, temperature=0.8, top_k=20, seed=7)
    out = cb.run()
    if verbose:
        print("greedy :", out[greedy])
        print("sampled:", out[sampled])
        print("target :", (np.arange(15, 23) + 1) % cfg.vocab_size)
    return {"losses": losses, "greedy": out[greedy],
            "sampled": out[sampled]}


if __name__ == "__main__":
    main()
