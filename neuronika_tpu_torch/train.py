"""High-level training loop for the functional transformer tier
(counterpart of `neuronika_tpu/train.py`).

`Trainer` ties together the train step (`models.transformer.
make_train_step`), a warmup-cosine LR schedule, gradient clipping and
accumulation, JSONL metrics (`utils.MetricsLogger`), checkpoints with
retention and resume (`utils.checkpoint.Checkpointer`) and periodic
held-out evaluation (`make_eval_step`):

    gen = torch.Generator("cuda").manual_seed(0)
    trainer = Trainer(cfg, generator=gen, lr=3e-4, warmup_steps=100,
                      total_steps=5000, checkpoint_dir="runs/gpt",
                      log_path="runs/gpt.jsonl")
    trainer.fit(batches, steps=5000)          # batches yields (tok, tgt)

The trainer runs on `config.device` ("cuda" unless a caller sets "cpu"):
its params live there (`params=` trees are moved there), batches are
moved there, and `generator`, JAX's `key`, must be a `torch.Generator` on
that device; it draws the attention-dropout seeds. `resume()` restores
the params, the Adam state, the step and the generator's state from the
latest checkpoint, so a killed run continues exactly where it stopped
(the same dropout masks included).

With `mesh` (a `parallel.make_mesh` DeviceMesh over dp, tp, cp and ep
axes; every rank builds its own Trainer and feeds it the same batches) the
trainer runs `make_sharded_train_step`: params and Adam moments live as
DTensors in the tp (and ep) layout, or the ZeRO-3 layout with `fsdp=True`
(JAX's `Trainer(mesh=, fsdp=)`), placed from rank 0's initial params; a pp
axis is refused, as JAX's Trainer has none; evaluation runs unsharded on
the gathered params and checkpoints hold full leaves (`Checkpointer`).
Clipping and accumulation are not ported on a mesh (JAX's sharded step
has neither and ignores them).

Everything here is host-side orchestration around the same step a
hand-written loop would call; `fit` reads each step's loss once
(`MetricsLogger.log`'s `float`), as JAX's does.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ._tree import tree_map
from .config import config
from .device import resolve
from .models import transformer as T
from .utils.checkpoint import Checkpointer
from .utils.metrics import MetricsLogger

__all__ = ["Trainer", "warmup_cosine"]


def warmup_cosine(base_lr: float, warmup_steps: int = 0,
                  total_steps: Optional[int] = None,
                  min_lr: float = 0.0) -> Callable[[int], float]:
    """step -> lr: linear warmup to `base_lr` over `warmup_steps`, then
    cosine decay to `min_lr` at `total_steps` (constant after warmup if
    `total_steps` is None)."""

    def lr(step: int) -> float:
        if warmup_steps and step < warmup_steps:
            return base_lr * (step + 1) / warmup_steps
        if total_steps is None:
            return base_lr
        t = min(max(step - warmup_steps, 0), total_steps - warmup_steps)
        frac = t / max(total_steps - warmup_steps, 1)
        return min_lr + 0.5 * (base_lr - min_lr) * (
            1.0 + math.cos(math.pi * frac))

    return lr


class Trainer:
    """Runs train steps with scheduling, logging, checkpointing and eval.
    See the module docstring for the shape of a run; every collaborator is
    also usable on its own."""

    def __init__(self, cfg: T.GPTConfig, *, generator: torch.Generator,
                 params=None, lr: float = 3e-4, warmup_steps: int = 0,
                 total_steps: Optional[int] = None, min_lr: float = 0.0,
                 grad_clip: float = 0.0, accum_steps: int = 1,
                 mesh=None, fsdp: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1000, keep: int = 3,
                 log_path: Optional[str] = None, print_every: int = 0,
                 eval_every: int = 0,
                 eval_batches: Optional[Callable[[], Iterable]] = None,
                 pad_id: Optional[int] = None):
        if mesh is not None and (grad_clip > 0.0 or accum_steps > 1):
            raise NotImplementedError(
                "Trainer(mesh=...) with grad_clip or accum_steps: clipping "
                "and accumulation are not ported on a mesh (ROADMAP.md "
                "queue 1 item 5)")
        if fsdp and mesh is None:
            raise ValueError("fsdp=True needs a mesh")
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve(config.device)
        if resolve(generator.device) != self.device:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"trainer on {self.device} (config.device)")
        self.generator = generator
        self.params = (T.init_params(generator, cfg, self.device)
                       if params is None
                       else tree_map(lambda t: t.to(self.device), params))
        if mesh is None:
            self._step = T.make_train_step(cfg, grad_clip=grad_clip,
                                           accum_steps=accum_steps)
        else:
            from .parallel.mesh import place

            self._step = T.make_sharded_train_step(mesh, cfg, fsdp=fsdp)
            sh = (T.fsdp_param_shardings(mesh, cfg) if fsdp
                  else T.param_shardings(mesh, cfg))
            self.params = tree_map(place, self.params, sh)
        # over DTensors the moments follow the params' layout
        self.opt_state = T.opt_init(self.params, cfg)
        self.lr_fn = warmup_cosine(lr, warmup_steps, total_steps, min_lr)
        self.step_num = 0
        self._ckpt = None
        self.checkpoint_every = checkpoint_every
        if checkpoint_dir is not None:
            self._ckpt = Checkpointer(checkpoint_dir, keep=keep)
        self._metrics_kw = dict(path=log_path, print_every=print_every)
        self.eval_every = eval_every
        self.eval_batches = eval_batches
        self.pad_id = pad_id
        self.last_eval: Optional[dict] = None

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ---------------------------------------------------------------- core
    def train_step(self, tokens, targets) -> torch.Tensor:
        """One step at the current schedule position; returns the loss as
        a 0-d tensor (read it with float() to sync)."""
        lr = torch.tensor(self.lr_fn(self.step_num), dtype=torch.float32)
        self.params, self.opt_state, loss = self._step(
            self.params, self.opt_state, self._on_device(tokens),
            self._on_device(targets), lr, self.generator)
        self.step_num += 1
        return loss

    def fit(self, batches: Iterable[Tuple[np.ndarray, np.ndarray]],
            steps: Optional[int] = None) -> dict:
        """Drive `batches` (an iterable of (tokens, targets)) until
        `step_num` reaches `steps` (or the batches run out), logging,
        checkpointing and evaluating on schedule. Returns the metrics
        summary."""
        it: Iterator = iter(batches)
        m = None
        try:
            while steps is None or self.step_num < steps:
                try:
                    tokens, targets = next(it)
                except StopIteration:
                    break
                if m is None:
                    B, S = tokens.shape[0], tokens.shape[1]
                    m = MetricsLogger(tokens_per_step=B * S,
                                      flops_per_step=T.flops_per_token(
                                          self.cfg, S) * B * S,
                                      **self._metrics_kw)
                loss = self.train_step(tokens, targets)
                rec = {"loss": loss, "lr": self.lr_fn(self.step_num - 1)}
                if self.eval_every and self.eval_batches is not None and (
                        self.step_num % self.eval_every == 0):
                    self.last_eval = self.evaluate(self.eval_batches())
                    rec["eval_loss"] = self.last_eval["loss"]
                m.log(self.step_num, **rec)
                if self._ckpt is not None and (
                        self.step_num % self.checkpoint_every == 0):
                    self.save()
            if self._ckpt is not None and (
                    self._ckpt.latest_step() != self.step_num):
                self.save(force=True)   # the final snapshot, unless the
                # periodic save already covered this step
            return m.summary() if m is not None else {}
        finally:
            if self._ckpt is not None:
                self._ckpt.wait()
            if m is not None:
                m.close()

    def evaluate(self, batches: Iterable) -> dict:
        """Exact dataset loss and perplexity over `batches` (one cached eval
        step; one sync per batch). On a mesh every rank evaluates the
        gathered params."""
        params = self.params
        if self.mesh is not None:
            params = tree_map(lambda t: t.full_tensor(), params)
        return T.evaluate(params, self.cfg, batches, pad_id=self.pad_id)

    # ------------------------------------------------------------ ckpt api
    def _state(self) -> dict:
        return {"params": self.params, "opt_state": self.opt_state,
                "step": torch.tensor(self.step_num, dtype=torch.int32),
                "generator": self.generator.get_state()}

    def save(self, force: bool = False) -> bool:
        """Checkpoint the train state at `step_num`; returns whether a save
        was made (see `Checkpointer.save`)."""
        if self._ckpt is None:
            raise ValueError("Trainer was built without checkpoint_dir")
        return self._ckpt.save(self.step_num, self._state(), force=force)

    def resume(self, step: Optional[int] = None) -> int:
        """Restore the params, optimizer state, step and generator state
        from the latest (or a given) checkpoint; returns the step."""
        if self._ckpt is None:
            raise ValueError("Trainer was built without checkpoint_dir")
        state = self._ckpt.restore(step, like=self._state())
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self.step_num = int(state["step"])
        self.generator.set_state(state["generator"])
        return self.step_num
