"""Continuous batching for GPT serving over a paged KV cache (counterpart
of `neuronika_tpu/serving.py`).

`ContinuousBatcher` is the host half of the JAX class: the request queue,
slot admission, per-request sampling, finishing and metrics. Its dense-slot
device programs are not ported, so it is the base of `PagedBatcher`, which
keeps K/V in a shared block pool (`models.transformer.init_paged_cache`)
and decodes through the paged-attention kernel.

* a new request prefills into a free slot in ONE batched pass, while the
  other slots' caches are untouched, so it joins the running batch
  mid-flight;
* every `step()` decodes one token for every active slot;
* a finished slot is freed at once and the next queued request takes it.

Sampling is per request (`submit(..., temperature=, top_k=, top_p=,
min_p=, seed=)`; temperature 0 = greedy, the default). A row's randomness
depends only on its own seed and step count (`sample_logits_batched`).

Not ported yet, and refused with `NotImplementedError`: quantized weights
(`quant`), chunked and bucketed prefill, tensor-parallel meshes, the prefix
cache, LoRA adapters and multi-step windows (`step_many`). Admission is
one request at a time; JAX's grouped admission is token-identical to it.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ._tree import tree_map
from .device import resolve
from .models import transformer as T


class _Request:
    __slots__ = ("rid", "prompt", "max_new", "tokens", "slot", "_seq",
                 "temperature", "top_k", "top_p", "min_p", "seed", "stop",
                 "on_token", "t_submit", "t_first", "t_done")

    def __init__(self, rid, prompt, max_new, temperature=0.0, top_k=0,
                 top_p=0.0, min_p=0.0, seed=None, stop=None, on_token=None):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        self._seq = 0            # admission order (preemption priority)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.min_p = float(min_p)
        self.seed = int(rid if seed is None else seed) & 0x7FFFFFFF
        # stop: iterable of token-id sequences; generation ends when the
        # output ends with any of them (the match is trimmed from the
        # returned tokens)
        self.stop = ([tuple(int(t) for t in np.atleast_1d(s))
                      for s in stop] if stop else [])
        self.on_token = on_token
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to neuronika_tpu_torch "
                               f"yet")


class ContinuousBatcher:
    """Host half of slot-based continuous batching; subclasses supply the
    device programs (`_build_programs`, `_prefill_slot`)."""

    # grouped admission (JAX's `_pop_prefill_group`) is not ported:
    # requests are admitted one at a time, which JAX's tests show gives
    # identical tokens
    _group_prefill = False

    def __init__(self, params, cfg: T.GPTConfig, n_slots: int,
                 quant: Optional[str] = None,
                 eos_id: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 mesh=None,
                 prefill_bucket=None, *, device):
        for name, value in (("quant", quant),
                            ("prefill_chunk", prefill_chunk),
                            ("mesh", mesh),
                            ("prefill_bucket", prefill_bucket)):
            if value is not None:
                raise _not_ported(f"{name}=")
        self.cfg = cfg
        self.device = resolve(device)
        # cast ONCE: the step is called per token
        self.params = tree_map(
            lambda t: t.to(self.device),
            T.prepare_decode_params(params, cfg))
        self.n_slots = n_slots
        self.eos_id = eos_id
        self._build_programs()
        self._free = deque(range(n_slots))
        self._queue: deque[_Request] = deque()
        self._running: Dict[int, _Request] = {}     # slot -> request
        self._next_tok = np.zeros((n_slots,), np.int32)
        self._next_rid = 0
        self._admit_seq = 0
        self._finished: Dict[int, np.ndarray] = {}
        self._stats = {"completed": 0, "tokens_out": 0,
                       "ttft_sum": 0.0, "itl_sum": 0.0, "itl_n": 0}

    def _build_programs(self) -> None:
        raise _not_ported("the dense-slot KV cache (use PagedBatcher)")

    def register_prefix(self, tokens) -> int:
        raise _not_ported("prefix caching (register_prefix)")

    def register_adapter(self, lora, alpha: float = 8.0) -> int:
        raise _not_ported("LoRA adapters (register_adapter)")

    def step_many(self, k: int) -> None:
        raise _not_ported("multi-step decode windows (step_many)")

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0, min_p: float = 0.0,
               seed: Optional[int] = None, adapter: int = 0,
               stop=None, on_token=None) -> int:
        """Queue a request (prompt: 1-d int array). Returns a request id;
        the request starts as soon as a slot frees up. Sampling controls
        and `stop` / `on_token` behave as in the JAX batcher; `adapter`
        must be 0 (no LoRA adapters are ported)."""
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        if prompt.shape[1] + max_new > self.cfg.max_seq:
            raise ValueError("prompt + max_new exceeds cfg.max_seq")
        if adapter:
            raise _not_ported("LoRA adapters (adapter=)")
        req = _Request(self._next_rid, prompt, max_new,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       min_p=min_p, seed=seed, stop=stop, on_token=on_token)
        self._next_rid += 1
        self._queue.append(req)
        self._admit()
        return req.rid

    # ----------------------------------------------------------- sampling
    def _sample_one(self, logits, req: _Request) -> int:
        """Sample the next token for one request from (V,) logits."""
        out = T.sample_logits_batched(
            logits.reshape(1, -1), [req.seed], [len(req.tokens)],
            [req.temperature], [req.top_k], [req.top_p], [req.min_p])
        return int(out[0])

    def _sample_batch(self, logits) -> np.ndarray:
        """Sample every running slot's next token from (B, V) logits."""
        B = self.n_slots
        seeds, steps = [0] * B, [0] * B
        temp, top_k, top_p, min_p = [0.0] * B, [0] * B, [0.0] * B, [0.0] * B
        for slot, req in self._running.items():
            seeds[slot] = req.seed
            steps[slot] = len(req.tokens)
            temp[slot] = req.temperature
            top_k[slot] = req.top_k
            top_p[slot] = req.top_p
            min_p[slot] = req.min_p
        out = T.sample_logits_batched(logits, seeds, steps, temp, top_k,
                                      top_p, min_p)
        return out.cpu().numpy().astype(np.int32)

    def _can_admit(self, req: _Request) -> bool:
        """Admission gate beyond a free slot (the paged subclass needs
        enough free blocks)."""
        return True

    def _req_row(self, req: _Request) -> np.ndarray:
        """The token row a (re-)prefill must cover: the prompt, plus, for
        a preempted request resuming, every generated token except the
        last (whose K/V was never written; it is the pending decode
        input)."""
        row = req.prompt[0]
        if req.tokens:
            row = np.concatenate(
                [row, np.asarray(req.tokens[:-1], np.int32)])
        return row

    def _admit(self) -> None:
        while self._queue and self._free and self._can_admit(self._queue[0]):
            req = self._queue.popleft()
            slot = self._free.popleft()
            req.slot = slot
            req._seq = self._admit_seq
            self._admit_seq += 1
            logits = self._prefill_slot(req, slot)
            if logits is not None:
                # a resumed (preempted) request restores _next_tok from
                # its own history and returns None instead of logits
                self._next_tok[slot] = self._sample_one(logits, req)
                self._emit(req, int(self._next_tok[slot]))
            self._running[slot] = req
            self._maybe_finish(slot)

    # ------------------------------------------------------------- decode
    def _extra_step_args(self) -> tuple:
        """Extra trailing args for the decode step (the paged subclass
        passes its block table)."""
        return ()

    def step(self) -> None:
        """One decode step across all occupied slots."""
        if not self._running:
            return
        decodable = list(self._running)
        active = np.zeros((self.n_slots,), bool)
        active[decodable] = True
        logits, self.cache = self._step(
            self.params, self.cache, self._dev(self._next_tok),
            self._dev(active), *self._extra_step_args())
        nxt = self._sample_batch(logits)
        for slot in decodable:
            if slot not in self._running:
                continue
            self._next_tok[slot] = nxt[slot]
            self._emit(self._running[slot], int(nxt[slot]))
            self._maybe_finish(slot)
        self._admit()

    def _emit(self, req: _Request, tok: int) -> None:
        """Record one generated token: history, first-token timestamp
        (TTFT), and the streaming callback."""
        req.tokens.append(tok)
        if req.t_first is None:
            req.t_first = time.monotonic()
        if req.on_token is not None:
            req.on_token(req.rid, tok)

    @staticmethod
    def _stop_match(req: _Request) -> int:
        """Length of the stop sequence the output currently ends with
        (0 = none)."""
        for s in req.stop:
            if len(req.tokens) >= len(s) and tuple(
                    req.tokens[-len(s):]) == s:
                return len(s)
        return 0

    def _maybe_finish(self, slot: int) -> None:
        req = self._running.get(slot)
        if req is None:
            return
        trim = self._stop_match(req)
        done = trim > 0 or len(req.tokens) >= req.max_new or (
            self.eos_id is not None and req.tokens
            and req.tokens[-1] == self.eos_id)
        if done:
            out = req.tokens[:-trim] if trim else req.tokens
            self._finished[req.rid] = np.asarray(out, np.int32)
            del self._running[slot]
            self._free.append(slot)
            req.t_done = time.monotonic()
            st = self._stats
            st["completed"] += 1
            st["tokens_out"] += len(req.tokens)
            if req.t_first is not None:
                st["ttft_sum"] += req.t_first - req.t_submit
                if len(req.tokens) > 1:
                    st["itl_sum"] += req.t_done - req.t_first
                    st["itl_n"] += len(req.tokens) - 1

    # ------------------------------------------------------------- drive
    def run(self, max_steps: int = 100000,
            multi_step: int = 1) -> Dict[int, np.ndarray]:
        """Decode until every submitted request finished; returns
        {rid: generated tokens (prompt excluded)}. Only `multi_step=1` is
        ported."""
        if multi_step != 1:
            raise _not_ported("multi-step decode windows (multi_step>1)")
        steps = 0
        while (self._running or self._queue) and steps < max_steps:
            self.step()
            steps += 1
        out, self._finished = self._finished, {}
        return out

    @property
    def stats(self) -> Tuple[int, int, int]:
        """(running, queued, free) slot counts."""
        return len(self._running), len(self._queue), len(self._free)

    @property
    def metrics(self) -> Dict[str, float]:
        """Serving latency/throughput over completed requests:
        `completed`, `tokens_out`, `ttft_mean_s` (submit -> first token,
        prefill + queueing), `itl_mean_s` (mean inter-token latency after
        the first). Host clock; means are 0.0 until something
        completes."""
        st = self._stats
        return {
            "completed": st["completed"],
            "tokens_out": st["tokens_out"],
            "ttft_mean_s": (st["ttft_sum"] / st["completed"]
                            if st["completed"] else 0.0),
            "itl_mean_s": (st["itl_sum"] / st["itl_n"]
                           if st["itl_n"] else 0.0),
        }


class PagedBatcher(ContinuousBatcher):
    """Continuous batching over a PAGED KV cache (vLLM-style block
    tables).

    K/V live in a shared pool of `n_blocks` fixed-size blocks and a
    request holds only the blocks its current length covers. Blocks are
    allocated on demand as sequences grow; when the pool runs dry the most
    recently admitted running request is PREEMPTED: its blocks are freed
    and it is re-queued at the front, to be re-prefilled (prompt + tokens
    so far) once space frees up. Preemption preserves exact greedy
    output: the re-prefill rebuilds the same K/V.

    Block 0 is scratch for inactive decode lanes and is never handed out.
    Device programs: `make_paged_prefill` / `make_paged_decode_step`
    (models/transformer.py); the block table is kept on the host and
    passed to the decode step each call. `kernel` is the decode step's
    attention path ("auto", "on", "off").

    >>> pb = PagedBatcher(params, cfg, n_slots=8, n_blocks=128,
    ...                   block_size=16, device="cuda")
    >>> rid = pb.submit(prompt_ids, max_new=64)
    >>> done = pb.run()
    """

    def __init__(self, params, cfg: T.GPTConfig, n_slots: int,
                 n_blocks: int, block_size: int = 16,
                 quant: Optional[str] = None,
                 eos_id: Optional[int] = None,
                 kernel: str = "auto",
                 prefill_chunk: Optional[int] = None,
                 mesh=None,
                 prefill_bucket=None, *, device):
        if n_blocks < 2:
            raise ValueError("n_blocks must be >= 2 (block 0 is scratch)")
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.kernel = kernel
        self._mb = -(-cfg.max_seq // block_size)     # table width
        super().__init__(params, cfg, n_slots, quant=quant, eos_id=eos_id,
                         prefill_chunk=prefill_chunk, mesh=mesh,
                         prefill_bucket=prefill_bucket, device=device)
        self._free_blocks: deque[int] = deque(range(1, n_blocks))
        self._table = np.zeros((n_slots, self._mb), np.int32)
        self._slot_blocks: Dict[int, List[int]] = {}
        self._pos = np.zeros((n_slots,), np.int64)   # host mirror of pos
        self.preemptions = 0

    def _build_programs(self) -> None:
        self._prefill = T.make_paged_prefill(self.cfg, self.block_size)
        self._step = T.make_paged_decode_step(self.cfg, self.block_size,
                                              kernel=self.kernel)
        self.cache = T.init_paged_cache(self.cfg, self.n_blocks,
                                        self.block_size, self.n_slots,
                                        self.device)

    # ------------------------------------------------------------ blocks
    def submit(self, prompt, max_new: int, **sampling) -> int:
        p = np.asarray(prompt).reshape(1, -1).shape[1]
        worst = -(-(p + max_new - 1) // self.block_size)
        if worst > self.n_blocks - 1:
            raise ValueError(
                f"request needs up to {worst} blocks but the pool has "
                f"{self.n_blocks - 1}; raise n_blocks or block_size")
        return super().submit(prompt, max_new, **sampling)

    def _can_admit(self, req: _Request) -> bool:
        return len(self._free_blocks) >= -(-self._req_row(req).size
                                           // self.block_size)

    def _prefill_slot(self, req: _Request, slot: int):
        """Allocate the row's blocks and prefill it; returns the
        last-position logits, or None for a resumed (preempted) request,
        whose next input is its own last token."""
        resumed = bool(req.tokens)
        row = self._req_row(req)
        nb = -(-row.size // self.block_size)
        blocks = [self._free_blocks.popleft() for _ in range(nb)]
        self._slot_blocks[slot] = blocks
        self._table[slot, :] = 0
        self._table[slot, :nb] = blocks
        logits, self.cache = self._prefill(
            self.params, self.cache, self._dev(row[None]), slot,
            self._dev(np.asarray(blocks, np.int32)))
        self._pos[slot] = row.size
        if resumed:
            self._next_tok[slot] = req.tokens[-1]
            return None
        return logits

    def _release_blocks(self, slot: int) -> None:
        for b in self._slot_blocks.pop(slot, []):
            self._free_blocks.append(b)
        self._table[slot, :] = 0

    def _preempt(self, slot: int) -> None:
        req = self._running.pop(slot)
        self._release_blocks(slot)
        self._free.append(slot)
        req.slot = None
        self.preemptions += 1
        self._queue.appendleft(req)     # resumes as soon as blocks free

    def _grow(self) -> None:
        """Before a decode step, every active slot must own the block
        covering the position it is about to write. Allocate on demand,
        oldest request first; when the pool is dry, preempt the most
        recently admitted OTHER request (vLLM scheduling: the oldest
        always makes progress, so no livelock)."""
        for slot in sorted(self._running,
                           key=lambda s: self._running[s]._seq):
            if slot not in self._running:    # preempted by an earlier turn
                continue
            blocks = self._slot_blocks[slot]
            need = int(self._pos[slot]) // self.block_size
            while len(blocks) <= need:
                if self._free_blocks:
                    b = self._free_blocks.popleft()
                    self._table[slot, len(blocks)] = b
                    blocks.append(b)
                    continue
                victim = max(
                    (s for s in self._running if s != slot),
                    key=lambda s: self._running[s]._seq, default=None)
                if victim is None:      # cannot happen if submit() gated
                    raise RuntimeError("paged KV pool too small for a "
                                       "single request")
                self._preempt(victim)
            self._pos[slot] += 1        # the step about to run writes here

    def step(self) -> None:
        if not self._running:
            self._admit()
            return
        self._grow()
        super().step()

    def _extra_step_args(self) -> tuple:
        return (self._dev(self._table),)

    def _maybe_finish(self, slot: int) -> None:
        req = self._running.get(slot)
        super()._maybe_finish(slot)
        if req is not None and slot not in self._running:
            self._release_blocks(slot)

    @property
    def block_stats(self) -> Tuple[int, int]:
        """(blocks in use, blocks free), block 0 excluded."""
        used = sum(len(v) for v in self._slot_blocks.values())
        return used, len(self._free_blocks)
