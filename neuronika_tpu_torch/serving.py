"""Continuous batching for GPT serving (counterpart of
`neuronika_tpu/serving.py`).

`ContinuousBatcher` keeps a fixed pool of cache slots (one dense
(max_seq) K/V row each) and runs the per-slot-position decode step
(`models.transformer.make_slot_decode_step`) over whatever mix of requests
occupies them; `PagedBatcher` keeps K/V in a shared block pool instead and
decodes through the paged-attention kernel (K11).

* a new request prefills into a free slot in ONE batched pass, while the
  other slots' caches are untouched, so it joins the running batch
  mid-flight;
* every `step()` decodes one token for every active slot;
* a finished slot is freed at once and the next queued request takes it.

Sampling is per request (`submit(..., temperature=, top_k=, top_p=,
min_p=, seed=)`; temperature 0 = greedy, the default). A row's randomness
depends only on its own seed and step count (`sample_logits_batched`).

Serving options, as in JAX: quantized weights (`quant="int8"` W8A8,
`"int4"` W4A16, `"int8-kv"` also an int8 KV cache on the dense batcher),
chunked prefill (`prefill_chunk`), bucketed prefill (`prefill_bucket`), a
prefix cache (`register_prefix`), grouped admission of a deferred burst
(`defer_admission`), multi-step decode windows (`step_many`,
`run(multi_step=)`), per-request LoRA adapters (`register_adapter`,
`submit(adapter=)`) and tensor-parallel serving (`mesh=`: a DeviceMesh
with a "tp" axis). On a mesh every rank runs the same scheduler on the
same requests and holds its tp slice of the prepared params and its
KV/tp heads of the cache (`models.transformer._ServeTP`); block tables,
slots and positions are whole and the same on every rank, the tp ranks
take tp rank 0's sampled tokens, and dp ranks hold replicas (JAX's
batcher leaves dp unsplit).
"""

from __future__ import annotations

import contextlib
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
                 "temperature", "top_k", "top_p", "min_p", "seed",
                 "adapter", "stop", "on_token", "t_submit", "t_first",
                 "t_done")

    def __init__(self, rid, prompt, max_new, temperature=0.0, top_k=0,
                 top_p=0.0, min_p=0.0, seed=None, adapter=0, stop=None,
                 on_token=None):
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
        self.adapter = int(adapter)
        # stop: iterable of token-id sequences; generation ends when the
        # output ends with any of them (the match is trimmed from the
        # returned tokens)
        self.stop = ([tuple(int(t) for t in np.atleast_1d(s))
                      for s in stop] if stop else [])
        self.on_token = on_token
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None


def _host32(a) -> np.ndarray:
    """A tensor or array as a float32 numpy array."""
    if torch.is_tensor(a):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed KV-cache pool.

    >>> cb = ContinuousBatcher(params, cfg, n_slots=8, quant="int8",
    ...                        device="cuda")
    >>> r1 = cb.submit(prompt_ids_1, max_new=64)
    >>> done = cb.run()          # {rid: np.ndarray of generated tokens}
    """

    # grouped admission; the paged subclass keeps it with block tables
    _group_prefill = True

    def __init__(self, params, cfg: T.GPTConfig, n_slots: int,
                 quant: Optional[str] = None,
                 eos_id: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 mesh=None,
                 prefill_bucket=None, *, device):
        # tensor-parallel serving: JAX's refusals first, before any
        # collective
        self._tp = None
        if mesh is not None:
            T._check_serving_mesh(mesh, cfg)
            self._tp = T._ServeTP(mesh, cfg)
        # prefill shape bucketing: "pow2" pads prompts to the next power of
        # two, an int N to the next multiple of N; the padded tail's K/V
        # are dead, so outputs are those of exact shapes
        if prefill_bucket is not None and prefill_bucket != "pow2" \
                and (not isinstance(prefill_bucket, int)
                     or prefill_bucket < 1):
            raise ValueError("prefill_bucket must be None, 'pow2', or a "
                             "positive int")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 tokens")
        self.cfg = cfg
        self.device = resolve(device)
        self.prefill_bucket = prefill_bucket
        # quantize or cast ONCE, on the device: the step is called per token;
        # a tp rank then takes its slice of the prepared tree
        self.params = T.prepare_decode_params(
            tree_map(lambda t: t.to(self.device), params), cfg, quant)
        if self._tp is not None:
            self.params = T._tp_params(self.params, cfg, self._tp)
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        self._chunk_fill = None              # built on first chunked prefill
        self._prefilling: Dict[int, _Request] = {}   # slot -> mid-prefill
        self._chunk_state: Dict[int, Tuple[np.ndarray, int]] = {}
        self._quant = quant
        self._suffix_prefill = None          # built on first register_prefix
        self._multi_prefill = None           # built on first group admit
        self._many_progs: Dict[int, object] = {}
        self._defer = False                  # see defer_admission()
        self._prefixes: List[tuple] = []
        self._adapter_trees: List[Dict] = []  # host copies, re-stackable
        self._adapters = None                 # stacked device tree or None
        self._sel = np.zeros((n_slots,), np.int64)  # per-slot adapter id
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

    def _dev(self, a) -> torch.Tensor:
        """A host array on the device. The copy does not wait for the
        device (no host sync); its source is staged when it returns."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    def _bucket_len(self, n: int) -> int:
        """Padded prompt length for bucketed prefill (min 16, capped at
        max_seq); `n` itself when bucketing is off."""
        b = self.prefill_bucket
        if b is None:
            return n
        if b == "pow2":
            out = max(16, 1 << (n - 1).bit_length())
        else:
            out = -(-n // b) * b
        return min(out, self.cfg.max_seq)

    def _pad_row(self, row: np.ndarray):
        """(padded (1, Pb) array, true length) for the bucketed prefill
        programs."""
        pb = self._bucket_len(row.size)
        out = np.zeros((1, pb), np.int32)
        out[0, :row.size] = row
        return out, row.size

    def _build_programs(self) -> None:
        """The prefill/decode programs and the KV cache (the paged
        subclass swaps in block-pool versions)."""
        self._prefill = T.make_slot_prefill(
            self.cfg, self._quant, bucketed=self.prefill_bucket is not None)
        self._step = T.make_slot_decode_step(self.cfg, self._quant)
        self.cache = T.init_slot_cache(self.cfg, self.n_slots,
                                       quant=self._quant, device=self.device,
                                       tp=self._tp)

    # ------------------------------------------------------------- prefix
    def register_prefix(self, tokens) -> int:
        """Precompute and cache the K/V of a shared prompt prefix (a system
        prompt, few-shot examples). A later request whose prompt starts
        with these tokens copies the cached K/V and prefills only the rest;
        the state equals a full prefill's, so outputs do not change.
        Longest prefix wins. Returns a prefix id (informational)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0 or tokens.size >= self.cfg.max_seq:
            raise ValueError("prefix must be 1..max_seq-1 tokens")
        if self._suffix_prefill is None:
            self._suffix_prefill = T.make_slot_suffix_prefill(
                self.cfg, self._quant,
                bucketed=self.prefill_bucket is not None)
            self._prefix_fill = T.make_prefill(self.cfg, self._quant)
        mini = T.init_kv_cache(self.cfg, 1, quant=self._quant,
                               device=self.device, tp=self._tp)
        _, mini = self._prefix_fill(self.params, mini,
                                    self._dev(tokens[None]))
        scales = (mini["ks"], mini["vs"]) if "ks" in mini else None
        self._prefixes.append((tokens, mini["k"], mini["v"], tokens.size,
                               scales))
        # longest-first so the first match is the best match
        self._prefixes.sort(key=lambda e: -e[3])
        return len(self._prefixes) - 1

    def _match_prefix(self, prompt_row: np.ndarray):
        """(pk, pv, plen, scales) of the longest registered prefix shorter
        than the row that the row starts with, or None."""
        for toks, pk, pv, plen, scales in self._prefixes:
            if plen < prompt_row.size and np.array_equal(
                    prompt_row[:plen], toks):
                return pk, pv, plen, scales
        return None

    # ----------------------------------------------------------- adapters
    def register_adapter(self, lora, alpha: float = 8.0) -> int:
        """Register a LoRA adapter for PER-REQUEST serving (S-LoRA): a mixed
        batch serves many fine-tunes of one base model in the same decode
        step. `lora` is a `models.lora.lora_init`-shaped tree ({target:
        {"A": (L, in, r), "B": (L, r, out)}}, tensors or arrays); alpha/r
        is folded into B here. All adapters are stacked into one device
        tree indexed by a per-slot selector; id 0 is the base model (a zero
        adapter); ranks and targets may differ (zero padding is exact).
        Returns the adapter id (1-based). Register adapters before
        serving: each registration re-stacks the tree. Prefix caching
        serves base-model requests only."""
        L = self.cfg.n_layer
        tree = {}
        for name, ab in lora.items():
            A, B = _host32(ab["A"]), _host32(ab["B"])
            if (A.ndim != 3 or B.ndim != 3 or A.shape[0] != L
                    or B.shape[0] != L or A.shape[2] != B.shape[1]):
                raise ValueError(
                    f"adapter target {name!r}: want A (L, in, r) / "
                    f"B (L, r, out) with L={L}, got {A.shape} / {B.shape}")
            tree[name] = (A, B * (alpha / A.shape[2]))
        if not tree:
            raise ValueError("adapter has no targets")
        self._adapter_trees.append(tree)
        self._restack_adapters()
        return len(self._adapter_trees)

    def _restack_adapters(self) -> None:
        """Rebuild the stacked device tree {target: {"A": (L, NA, in, R),
        "B": (L, NA, R, out)}} from the host copies (adapter 0 = zeros =
        base model), in the compute dtype."""
        L = self.cfg.n_layer
        NA = len(self._adapter_trees) + 1
        names = sorted({n for t in self._adapter_trees for n in t})
        out = {}
        for name in names:
            entries = [t.get(name) for t in self._adapter_trees]
            have = [e for e in entries if e is not None]
            d_in, d_out = have[0][0].shape[1], have[0][1].shape[2]
            R = max(e[0].shape[2] for e in have)
            A = np.zeros((L, NA, d_in, R), np.float32)
            B = np.zeros((L, NA, R, d_out), np.float32)
            for i, e in enumerate(entries, start=1):
                if e is None:
                    continue
                r = e[0].shape[2]
                A[:, i, :, :r] = e[0]
                B[:, i, :r, :] = e[1]
            # a tp rank keeps its rows of A (row-parallel leaves) or its
            # columns of B (column-parallel ones)
            A, B = T._tp_adapter(name, torch.from_numpy(A),
                                 torch.from_numpy(B), self._tp)
            out[name] = {"A": A.to(self.device).to(self.cfg.dtype),
                         "B": B.to(self.device).to(self.cfg.dtype)}
        self._adapters = out

    def _lora_args(self) -> tuple:
        """Trailing (adapters, sel) for the decode step; () when no adapter
        is registered."""
        if self._adapters is None:
            return ()
        return (self._adapters, self._dev(self._sel))

    def _lora_prefill_args(self, req: _Request) -> tuple:
        if self._adapters is None:
            return ()
        return (self._adapters,
                self._dev(np.full((1,), req.adapter, np.int64)))

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0, min_p: float = 0.0,
               seed: Optional[int] = None, adapter: int = 0,
               stop=None, on_token=None) -> int:
        """Queue a request (prompt: 1-d int array). Returns a request id;
        the request starts as soon as a slot frees up.

        Sampling is per request: temperature 0 (default) is greedy;
        temperature/top_k/top_p/min_p mirror `make_generate`'s controls.
        `seed` (default: the request id) makes the request's tokens
        reproducible whatever it is co-batched with. `adapter` selects a
        LoRA adapter from `register_adapter` (0 = base model). `stop`:
        token-id sequences that end generation (the match is trimmed;
        eos_id is kept). `on_token(rid, token_id)` streams each token as
        it is sampled."""
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        if prompt.shape[1] + max_new > self.cfg.max_seq:
            raise ValueError("prompt + max_new exceeds cfg.max_seq")
        if not 0 <= adapter <= len(self._adapter_trees):
            raise ValueError(
                f"adapter id {adapter} not registered (have "
                f"{len(self._adapter_trees)}; 0 = base model)")
        req = _Request(self._next_rid, prompt, max_new,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       min_p=min_p, seed=seed, adapter=adapter,
                       stop=stop, on_token=on_token)
        self._next_rid += 1
        self._queue.append(req)
        if not self._defer:
            self._admit()
        return req.rid

    def defer_admission(self):
        """Context manager that holds admission while a burst of requests
        is submitted; they admit TOGETHER on exit, so same-shape prompts
        land in one grouped multi-row prefill (`_prefill_group`: one
        weight read and one host round trip a group).

        >>> with cb.defer_admission():
        ...     rids = [cb.submit(p, 64) for p in prompts]
        """

        @contextlib.contextmanager
        def _ctx():
            self._defer = True
            try:
                yield
            finally:
                self._defer = False
                self._admit()

        return _ctx()

    # ----------------------------------------------------------- sampling
    def _sample(self, logits, reqs):
        """Per-row sampling of (m, V) logits for `reqs` (None: an idle
        row) -> (m,) tokens on the device; on a tp mesh tp rank 0's."""
        return T._tp_tokens(self._tp, T.sample_logits_batched(
            logits, *self._controls(reqs)))

    def _sample_one(self, logits, req: _Request) -> int:
        """Sample the next token for one request from (V,) logits."""
        return int(self._sample(logits.reshape(1, -1), [req])[0])

    def _controls(self, reqs) -> tuple:
        """(seeds, steps, temperature, top_k, top_p, min_p) host lists for
        the rows `reqs` (None for an idle row)."""
        cols = ([], [], [], [], [], [])
        for r in reqs:
            vals = ((0, 0, 0.0, 0, 0.0, 0.0) if r is None else
                    (r.seed, len(r.tokens), r.temperature, r.top_k, r.top_p,
                     r.min_p))
            for c, v in zip(cols, vals):
                c.append(v)
        return cols

    def _slot_reqs(self) -> list:
        return [self._running.get(s) for s in range(self.n_slots)]

    def _sample_batch(self, logits) -> np.ndarray:
        """Sample every running slot's next token from (B, V) logits."""
        out = self._sample(logits, self._slot_reqs())
        return out.cpu().numpy().astype(np.int32)

    def _can_admit(self, req: _Request) -> bool:
        """Admission gate beyond a free slot (the paged subclass also needs
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

    # ---------------------------------------------------- chunked prefill
    def _should_chunk(self, req: _Request) -> bool:
        """Chunk a prefill when it is longer than `prefill_chunk` and takes
        the full-prefill path (prefix-cache hits stay one-shot: the suffix
        is already short)."""
        C = self.prefill_chunk
        if not C or self._req_row(req).size <= C:
            return False
        return bool(req.adapter) or self._match_prefix(req.prompt[0]) is None

    def _chunk_call(self, req: _Request, slot: int, chunk: np.ndarray,
                    start: int):
        """One chunk-prefill call (the paged subclass adds the table row);
        returns the chunk's last-position logits."""
        if self._chunk_fill is None:
            self._chunk_fill = T.make_slot_chunk_prefill(self.cfg,
                                                         self._quant)
        logits, self.cache = self._chunk_fill(
            self.params, self.cache, self._dev(chunk[None]), slot, start,
            *self._lora_prefill_args(req))
        return logits

    def _start_chunked(self, req: _Request, slot: int) -> None:
        """Admit `req` in chunked-prefill mode: the FIRST chunk now, the
        rest one per `step()` (`_advance_chunks`), so co-running decodes
        stall at most one chunk's time per token (SARATHI-style)."""
        row = self._req_row(req)
        C = self.prefill_chunk
        self._chunk_call(req, slot, row[:C], 0)
        self._chunk_state[slot] = (row, C)
        self._prefilling[slot] = req

    def _note_prefilled(self, slot: int, row_len: int) -> None:
        """Hook when a chunked prefill completes (the paged subclass syncs
        its host position mirror)."""

    def _advance_chunks(self) -> None:
        """Advance ONE mid-prefill slot by one chunk (admission order). The
        final chunk covers the row's LAST `C` tokens: the overlap with the
        previous chunk rewrites the same K/V, so no chunk is padded."""
        if not self._prefilling:
            return
        slot = min(self._prefilling, key=lambda s: self._prefilling[s]._seq)
        req = self._prefilling[slot]
        row, ns = self._chunk_state[slot]
        C = self.prefill_chunk
        final = ns + C >= row.size
        start = row.size - C if final else ns
        logits = self._chunk_call(req, slot, row[start:start + C], start)
        if not final:
            self._chunk_state[slot] = (row, ns + C)
            return
        del self._prefilling[slot], self._chunk_state[slot]
        self._note_prefilled(slot, row.size)
        if req.tokens:      # resumed after preemption: restore, don't sample
            self._next_tok[slot] = req.tokens[-1]
        else:
            self._next_tok[slot] = self._sample_one(logits, req)
            self._emit(req, int(self._next_tok[slot]))
        self._maybe_finish(slot)

    def _prefill_slot(self, req: _Request, slot: int):
        """Prefill `req` into `slot`; returns the last-position logits."""
        pref = None if req.adapter else self._match_prefix(req.prompt[0])
        if pref is not None:
            pk, pv, plen, scales = pref
            if self.prefill_bucket is not None:
                padded, cs = self._pad_row(req.prompt[0, plen:])
                padded = padded[:, :self.cfg.max_seq - plen]
                logits, self.cache = self._suffix_prefill(
                    self.params, self.cache, pk, pv, plen,
                    self._dev(padded), cs, slot, scales=scales)
            else:
                logits, self.cache = self._suffix_prefill(
                    self.params, self.cache, pk, pv, plen,
                    self._dev(req.prompt[:, plen:]), slot, scales=scales)
        elif self.prefill_bucket is not None:
            padded, plen = self._pad_row(req.prompt[0])
            logits, self.cache = self._prefill(
                self.params, self.cache, self._dev(padded), plen, slot,
                *self._lora_prefill_args(req))
        else:
            logits, self.cache = self._prefill(
                self.params, self.cache, self._dev(req.prompt), slot,
                *self._lora_prefill_args(req))
        return logits

    # -------------------------------------------------- grouped admission
    def _group_eligible(self, req: _Request) -> bool:
        """A request the multi-row prefill can admit: base model, fresh
        (not a preemption resume), un-chunked, no prefix-cache hit."""
        return (req.adapter == 0 and not req.tokens
                and not self._should_chunk(req)
                and self._match_prefix(req.prompt[0]) is None)

    def _pop_prefill_group(self):
        """Pop the run of front-of-queue requests that share a padded
        prefill shape (while free slots last) for ONE multi-row prefill
        call, or None for the single-request path. Grouping never reorders
        the queue, so admission stays FIFO."""
        if (not self._group_prefill or len(self._queue) < 2
                or len(self._free) < 2
                or not self._group_eligible(self._queue[0])):
            return None
        pb = self._bucket_len(self._queue[0].prompt.shape[1])
        claimed = self._group_claim(self._queue[0])
        n = 1
        while (n < len(self._queue) and n < len(self._free)
               and self._group_eligible(self._queue[n])
               and self._bucket_len(self._queue[n].prompt.shape[1]) == pb
               and self._group_can_extend(self._queue[n], claimed)):
            claimed += self._group_claim(self._queue[n])
            n += 1
        if n < 2:
            return None
        group = []
        for _ in range(n):
            req = self._queue.popleft()
            slot = self._free.popleft()
            req.slot = slot
            req._seq = self._admit_seq
            self._admit_seq += 1
            self._sel[slot] = 0
            group.append((req, slot))
        return group

    def _group_claim(self, req: _Request) -> int:
        """Pool resources a group member takes (the paged subclass counts
        blocks; the dense cache needs nothing beyond the slot)."""
        return 0

    def _group_can_extend(self, req: _Request, claimed: int) -> bool:
        """Whether `req` fits the group given what earlier members already
        claimed."""
        return self._can_admit(req)

    def _group_prefill_call(self, prompts, plens, slots, group):
        """The device call for one grouped admission; returns (logits
        (m, V), cache). The paged subclass allocates each row's blocks and
        calls its block-table program."""
        if self._multi_prefill is None:
            self._multi_prefill = T.make_slot_prefill_multi(self.cfg,
                                                            self._quant)
        return self._multi_prefill(self.params, self.cache,
                                   self._dev(prompts), self._dev(plens),
                                   self._dev(slots))

    def _prefill_group(self, group) -> None:
        """Admit a group in one multi-row prefill call. The group rounds
        up to a power-of-two row count by replicating row 0 (prompt, plen
        AND slot), so duplicate writes carry the same values and few row
        counts occur. First tokens are sampled in one batched call with
        the per-request sampler: outputs equal the single path's."""
        rows = [self._pad_row(req.prompt[0]) for req, _ in group]
        m_real = len(group)
        m = 1 << (m_real - 1).bit_length()
        pad = m - m_real
        prompts = np.concatenate([r[0] for r in rows]
                                 + [rows[0][0]] * pad, axis=0)
        plens = np.asarray([r[1] for r in rows] + [rows[0][1]] * pad,
                           np.int32)
        slots = np.asarray([s for _, s in group] + [group[0][1]] * pad,
                           np.int64)
        logits, self.cache = self._group_prefill_call(
            prompts, plens, slots, group)
        reqs = [req for req, _ in group] + [group[0][0]] * pad
        toks = self._sample(logits, reqs).cpu().numpy()
        for i, (req, slot) in enumerate(group):
            self._running[slot] = req
            self._next_tok[slot] = int(toks[i])
            self._emit(req, int(toks[i]))
            self._maybe_finish(slot)

    def _admit(self) -> None:
        while self._queue and self._free and self._can_admit(self._queue[0]):
            group = self._pop_prefill_group()
            if group is not None:
                self._prefill_group(group)
                continue
            req = self._queue.popleft()
            slot = self._free.popleft()
            req.slot = slot
            req._seq = self._admit_seq
            self._admit_seq += 1
            self._sel[slot] = req.adapter
            if self._should_chunk(req):
                self._start_chunked(req, slot)
                self._running[slot] = req
                continue
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

    # --------------------------------------------------------- multi-step
    def _grow_many(self, k: int) -> bool:
        """Reserve what the next k decode steps need (the paged subclass
        allocates blocks, preempting under pressure). False when the
        window cannot be reserved."""
        return True

    def _many_prog(self, k: int):
        if k not in self._many_progs:
            self._many_progs[k] = T.make_slot_decode_many(self.cfg, k,
                                                          self._quant)
        return self._many_progs[k]

    def step_many(self, k: int) -> None:
        """Run up to k decode steps in ONE program call with ONE read of
        the tokens to the host (multi-step scheduling), where `step()`
        reads every step's tokens to detect finishes.

        The tokens are EXACTLY the per-step path's: each row's sampling
        depends only on its own seed and step count and its own causal
        lane, so tokens a request would not have made (past its stop or
        eos) are discarded; the window is capped at the tightest remaining
        budget (rounded down to a power of two). Finishes are seen at
        window ends, so a freed slot admits a queued request up to k-1
        steps later, and streaming callbacks arrive in bursts. Falls back
        to `step()` while a slot is mid-chunked-prefill."""
        if k <= 1 or not self._running or self._prefilling:
            self.step()
            return
        k = min([k] + [r.max_new - len(r.tokens)
                       for r in self._running.values()])
        k = 1 << (k.bit_length() - 1) if k > 0 else 0
        if k <= 1 or not self._grow_many(k):
            self.step()
            return
        B = self.n_slots
        active = np.zeros((B,), bool)
        active[list(self._running)] = True
        toks, self.cache = self._many_prog(k)(
            self.params, self.cache, self._dev(self._next_tok),
            self._dev(active), *self._extra_step_args(),
            *self._controls(self._slot_reqs()), *self._lora_args())
        toks = toks.cpu().numpy()        # (k, B): the ONE read
        for slot in [s for s in range(B) if active[s]]:
            req = self._running[slot]
            col = toks[:, slot]
            if req.stop or req.on_token is not None:
                # stop sequences match across the window boundary and
                # callbacks want per-token calls
                for tok in col:
                    if slot not in self._running:
                        break            # later tokens are discarded
                    self._next_tok[slot] = int(tok)
                    self._emit(req, int(tok))
                    self._maybe_finish(slot)
                continue
            # accept through the first eos, discard the overshoot
            n = k
            if self.eos_id is not None:
                hits = np.flatnonzero(col == self.eos_id)
                if hits.size:
                    n = int(hits[0]) + 1
            if req.t_first is None:
                req.t_first = time.monotonic()
            req.tokens.extend(int(t) for t in col[:n])
            self._next_tok[slot] = int(col[n - 1])
            self._maybe_finish(slot)
        # a slot that finished mid-window kept decoding; its overshoot K/V
        # and position are rewritten by the next prefill into the slot
        self._admit()

    def step(self) -> None:
        """One decode step across all occupied slots (plus at most one
        prefill chunk for a slot still mid-prefill)."""
        if not self._running:
            return
        self._advance_chunks()
        decodable = [s for s in self._running if s not in self._prefilling]
        if decodable:
            active = np.zeros((self.n_slots,), bool)
            active[decodable] = True
            logits, self.cache = self._step(
                self.params, self.cache, self._dev(self._next_tok),
                self._dev(active), *self._extra_step_args(),
                *self._lora_args())
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
        {rid: generated tokens (prompt excluded)}. `multi_step=k` drives
        the loop with `step_many(k)` (one host read per window; the same
        tokens)."""
        steps = 0
        while (self._running or self._queue) and steps < max_steps:
            if multi_step > 1:
                self.step_many(multi_step)
            else:
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
    The block table is kept on the host and passed to the decode step each
    call. `kernel` is the decode attention path ("auto", "on", "off"), in
    per-step and multi-step decode alike, and on a mesh too: a tp rank's
    pool is a plain local tensor holding its kv heads whole, so "auto" and
    "on" run K11 on it (JAX's Pallas call cannot take a GSPMD-sharded pool
    and falls back to its gather path there). `quant="int8-kv"` is
    refused, as JAX refuses it.

    >>> pb = PagedBatcher(params, cfg, n_slots=8, n_blocks=128,
    ...                   block_size=16, quant="int8", device="cuda")
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
        self._slot_shared: Dict[int, int] = {}       # leading shared blocks
        self._pos = np.zeros((n_slots,), np.int64)   # host mirror of pos
        self.preemptions = 0
        self._paged_prefixes: List[Tuple[np.ndarray, np.ndarray]] = []
        self._n_reserved = 0                         # blocks held by prefixes
        self._paged_suffix = None

    def _build_programs(self) -> None:
        self._prefill = T.make_paged_prefill(
            self.cfg, self.block_size, self._quant,
            bucketed=self.prefill_bucket is not None)
        self._step = T.make_paged_decode_step(self.cfg, self.block_size,
                                              self._quant,
                                              kernel=self.kernel)
        self.cache = T.init_paged_cache(self.cfg, self.n_blocks,
                                        self.block_size, self.n_slots,
                                        self.device, tp=self._tp)

    def register_prefix(self, tokens) -> int:
        """Precompute a shared prompt prefix's K/V into dedicated pool
        blocks (vLLM full-block sharing). Only whole blocks are shared:
        `len(tokens) // block_size` blocks are reserved for the batcher's
        lifetime; the remainder re-prefills with each request's suffix.
        Matching requests point their table's leading entries at the
        shared blocks (read-only: decode writes land past the prefix).
        Longest prefix wins; outputs do not change."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        BS = self.block_size
        nf = tokens.size // BS
        if nf < 1:
            raise ValueError(
                f"prefix must cover at least one full block "
                f"({BS} tokens); got {tokens.size}")
        if tokens.size >= self.cfg.max_seq:
            raise ValueError("prefix must be < max_seq tokens")
        if len(self._free_blocks) < nf:
            raise ValueError(
                f"prefix needs {nf} pool blocks but only "
                f"{len(self._free_blocks)} are free")
        if self._paged_suffix is None:
            self._paged_suffix = T.make_paged_suffix_prefill(
                self.cfg, BS, self._quant,
                bucketed=self.prefill_bucket is not None)
            self._prefix_fill = T.make_prefill(self.cfg, self._quant)
        cut = nf * BS
        blocks = np.asarray(
            [self._free_blocks.popleft() for _ in range(nf)], np.int32)
        self._n_reserved += nf
        mini = T.init_kv_cache(self.cfg, 1, device=self.device, tp=self._tp)
        _, mini = self._prefix_fill(self.params, mini,
                                    self._dev(tokens[None, :cut]))
        T._scatter_blocks(self.cache, mini["k"][:, :, :, :cut],
                          mini["v"][:, :, :, :cut],
                          self._dev(blocks).long(), BS)
        self._paged_prefixes.append((tokens[:cut], blocks))
        self._paged_prefixes.sort(key=lambda e: -e[0].size)
        return len(self._paged_prefixes) - 1

    def _match_paged_prefix(self, row: np.ndarray):
        for toks, blocks in self._paged_prefixes:
            if toks.size < row.size and np.array_equal(
                    row[:toks.size], toks):
                return toks.size, blocks
        return None

    # ------------------------------------------------------------ blocks
    def submit(self, prompt, max_new: int, **sampling) -> int:
        p = np.asarray(prompt).reshape(1, -1).shape[1]
        worst = -(-(p + max_new - 1) // self.block_size)
        if worst > self.n_blocks - 1 - self._n_reserved:
            raise ValueError(
                f"request needs up to {worst} blocks but the pool has "
                f"{self.n_blocks - 1 - self._n_reserved}; raise n_blocks "
                f"or block_size")
        return super().submit(prompt, max_new, **sampling)

    def _can_admit(self, req: _Request) -> bool:
        row = self._req_row(req)
        pref = None if req.adapter else self._match_paged_prefix(row)
        nf = len(pref[1]) if pref is not None else 0
        return len(self._free_blocks) >= -(-row.size
                                           // self.block_size) - nf

    def _should_chunk(self, req: _Request) -> bool:
        C = self.prefill_chunk
        row = self._req_row(req)
        if not C or row.size <= C:
            return False
        return (bool(req.adapter)
                or self._match_paged_prefix(row) is None)

    def _own_blocks(self, slot: int, nb: int, shared=None) -> List[int]:
        """Take `nb` blocks from the pool for `slot` and write its table
        row: the shared prefix blocks first (if any), then its own."""
        shared = [] if shared is None else list(shared)
        own = [self._free_blocks.popleft() for _ in range(nb)]
        self._slot_blocks[slot] = own
        self._slot_shared[slot] = len(shared)
        self._table[slot, :] = 0
        self._table[slot, :len(shared) + nb] = shared + own
        return own

    def _start_chunked(self, req: _Request, slot: int) -> None:
        # allocate the whole row's blocks up front (the one-shot path's
        # accounting); chunks then fill them
        self._own_blocks(slot, -(-self._req_row(req).size // self.block_size))
        super()._start_chunked(req, slot)

    def _chunk_call(self, req: _Request, slot: int, chunk: np.ndarray,
                    start: int):
        if self._chunk_fill is None:
            self._chunk_fill = T.make_paged_chunk_prefill(
                self.cfg, self.block_size, self._quant)
        logits, self.cache = self._chunk_fill(
            self.params, self.cache, self._dev(chunk[None]), slot, start,
            self._dev(self._table[slot]), *self._lora_prefill_args(req))
        return logits

    def _note_prefilled(self, slot: int, row_len: int) -> None:
        self._pos[slot] = row_len

    # ------------------------------------------------- grouped admission
    def _group_eligible(self, req: _Request) -> bool:
        # paged prefix hits go through _match_paged_prefix (block sharing)
        return (req.adapter == 0 and not req.tokens
                and not self._should_chunk(req)
                and self._match_paged_prefix(req.prompt[0]) is None)

    def _group_claim(self, req: _Request) -> int:
        return -(-req.prompt.shape[1] // self.block_size)

    def _group_can_extend(self, req: _Request, claimed: int) -> bool:
        # blocks the earlier group members will take are spoken for
        return (len(self._free_blocks) - claimed
                >= -(-req.prompt.shape[1] // self.block_size))

    def _group_prefill_call(self, prompts, plens, slots, group):
        """Allocate each member's blocks and prefill the group through ONE
        block-table program (`make_paged_prefill_multi`). Padding rows
        replicate row 0's table; entries past a row's real blocks point
        at scratch block 0, whose contents are never read."""
        BS = self.block_size
        m, Pb = prompts.shape
        tables = np.zeros((m, -(-Pb // BS)), np.int32)
        for i, (req, slot) in enumerate(group):
            size = int(plens[i])
            own = self._own_blocks(slot, -(-size // BS))
            tables[i, :len(own)] = own
            self._pos[slot] = size
        tables[len(group):] = tables[0]
        if self._multi_prefill is None:
            self._multi_prefill = T.make_paged_prefill_multi(
                self.cfg, self.block_size, self._quant)
        return self._multi_prefill(
            self.params, self.cache, self._dev(prompts), self._dev(plens),
            self._dev(slots), self._dev(tables))

    def _prefill_slot(self, req: _Request, slot: int):
        resumed = bool(req.tokens)
        row = self._req_row(req)
        BS = self.block_size
        pref = None if req.adapter else self._match_paged_prefix(row)
        if pref is not None:
            cut, shared = pref
            own = self._own_blocks(slot, -(-row.size // BS) - len(shared),
                                   shared)
            if self.prefill_bucket is not None:
                padded, cs = self._pad_row(row[cut:])
                padded = padded[:, :self.cfg.max_seq - cut]
                # own blocks padded with scratch block 0 to the bucket's
                # static width: the padded tail's K/V land there
                brow = np.zeros((-(-(cut + padded.shape[1]) // BS)
                                 - len(shared),), np.int32)
                brow[:len(own)] = own
                logits, self.cache = self._paged_suffix(
                    self.params, self.cache, self._dev(padded), cs, slot,
                    self._dev(brow), self._dev(shared))
            else:
                logits, self.cache = self._paged_suffix(
                    self.params, self.cache, self._dev(row[None, cut:]),
                    slot, self._dev(np.asarray(own, np.int32)),
                    self._dev(shared))
        elif self.prefill_bucket is not None:
            own = self._own_blocks(slot, -(-row.size // BS))
            padded, plen = self._pad_row(row)
            brow = np.zeros((-(-padded.shape[1] // BS),), np.int32)
            brow[:len(own)] = own
            logits, self.cache = self._prefill(
                self.params, self.cache, self._dev(padded), plen, slot,
                self._dev(brow), *self._lora_prefill_args(req))
        else:
            own = self._own_blocks(slot, -(-row.size // BS))
            logits, self.cache = self._prefill(
                self.params, self.cache, self._dev(row[None]), slot,
                self._dev(np.asarray(own, np.int32)),
                *self._lora_prefill_args(req))
        self._pos[slot] = row.size
        if resumed:
            self._next_tok[slot] = req.tokens[-1]
            return None
        return logits

    def _release_blocks(self, slot: int) -> None:
        for b in self._slot_blocks.pop(slot, []):
            self._free_blocks.append(b)
        self._slot_shared.pop(slot, None)
        self._table[slot, :] = 0

    def _preempt(self, slot: int) -> None:
        req = self._running.pop(slot)
        self._release_blocks(slot)
        self._free.append(slot)
        # a mid-prefill victim drops its chunk progress with its blocks;
        # it re-chunks from scratch on re-admission
        self._prefilling.pop(slot, None)
        self._chunk_state.pop(slot, None)
        req.slot = None
        self.preemptions += 1
        self._queue.appendleft(req)     # resumes as soon as blocks free

    def _victim(self, slot: int):
        """The most recently admitted running request other than `slot`
        (vLLM scheduling: the oldest always makes progress), or None."""
        return max((s for s in self._running if s != slot),
                   key=lambda s: self._running[s]._seq, default=None)

    def _grow(self) -> None:
        """Before a decode step, every active slot must own the block
        covering the position it is about to write. Allocate on demand,
        oldest request first; when the pool is dry, preempt the most
        recently admitted OTHER request."""
        for slot in sorted(self._running,
                           key=lambda s: self._running[s]._seq):
            if slot not in self._running:    # preempted by an earlier turn
                continue
            if slot in self._prefilling:     # not decoding yet: no growth
                continue
            blocks = self._slot_blocks[slot]
            shared = self._slot_shared.get(slot, 0)
            need = int(self._pos[slot]) // self.block_size
            while shared + len(blocks) <= need:
                if self._free_blocks:
                    b = self._free_blocks.popleft()
                    self._table[slot, shared + len(blocks)] = b
                    blocks.append(b)
                    continue
                victim = self._victim(slot)
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

    def _many_prog(self, k: int):
        if k not in self._many_progs:
            # the window keeps the per-step program's attention path: K11
            # on the card under "auto" and "on"
            self._many_progs[k] = T.make_paged_decode_many(
                self.cfg, self.block_size, k, self._quant,
                kernel=self.kernel)
        return self._many_progs[k]

    def _grow_many(self, k: int) -> bool:
        """Reserve every running slot's blocks through position pos+k-1
        (the window's table is fixed on the device), preempting the most
        recently admitted other request when the pool runs dry, as
        per-step `_grow` does, paid up front. A window that cannot be
        hosted even by preempting every peer returns False BEFORE anyone
        is evicted. Advances the host position mirror by k."""
        for slot in sorted(self._running,
                           key=lambda s: self._running[s]._seq):
            if slot not in self._running:    # preempted below
                continue
            blocks = self._slot_blocks[slot]
            shared = self._slot_shared.get(slot, 0)
            need = (int(self._pos[slot]) + k - 1) // self.block_size
            while shared + len(blocks) <= need:
                if self._free_blocks:
                    b = self._free_blocks.popleft()
                    self._table[slot, shared + len(blocks)] = b
                    blocks.append(b)
                    continue
                remaining = need + 1 - (shared + len(blocks))
                reclaimable = sum(len(self._slot_blocks[s])
                                  for s in self._running if s != slot)
                victim = self._victim(slot)
                if reclaimable < remaining or victim is None:
                    return False     # shrink the window instead
                self._preempt(victim)
        for slot in self._running:
            self._pos[slot] += k
        return True

    def _extra_step_args(self) -> tuple:
        return (self._dev(self._table),)

    def _maybe_finish(self, slot: int) -> None:
        req = self._running.get(slot)
        super()._maybe_finish(slot)
        if req is not None and slot not in self._running:
            self._release_blocks(slot)

    @property
    def block_stats(self) -> Tuple[int, int]:
        """(blocks in use, blocks free): block 0 and the blocks registered
        prefixes hold are left out."""
        used = sum(len(v) for v in self._slot_blocks.values())
        return used, len(self._free_blocks)

    @property
    def reserved_blocks(self) -> int:
        """Pool blocks permanently held by registered prefixes."""
        return self._n_reserved
