"""Training metrics logging (counterpart of `neuronika_tpu/utils/metrics.py`,
a copy: the module imports nothing of JAX).

`MetricsLogger` is a dependency-free JSONL scalar logger with EMA
smoothing and derived throughput:

    with MetricsLogger("runs/exp1.jsonl", print_every=50,
                       tokens_per_step=B * S) as m:
        for step in range(steps):
            params, opt, loss = train_step(...)
            m.log(step, loss=loss, lr=lr)

* device scalars are coerced with `float(...)`, the ONE sync point per
  log call (don't pass whole tensors);
* each record carries wall-time deltas, steps/s and (if
  `tokens_per_step` is set) tokens/s;
* `ema` keys smooth noisy scalars (loss) with bias correction;
* the JSONL file is append-only and crash-safe (one flushed line per
  log): resumable runs keep appending, and anything downstream (pandas,
  jq, a plotting notebook) reads it directly.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, print_every: int = 0,
                 ema: float = 0.98, tokens_per_step: Optional[int] = None,
                 flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None) -> None:
        """`path`: JSONL sink (None = in-memory only). `print_every`:
        console line every N log calls (0 = silent). `ema`: smoothing
        factor for the `*_ema` keys. `tokens_per_step` /
        `flops_per_step` + `peak_flops`: enable derived tokens/s and
        MFU columns."""
        self._fh = open(path, "a") if path else None
        self.print_every = print_every
        self.ema_decay = ema
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self._ema: Dict[str, float] = {}
        self._n = 0
        self._last_t: Optional[float] = None
        self._last_step: Optional[int] = None
        self.history: list = []

    # ------------------------------------------------------------------
    def log(self, step: int, **scalars) -> Dict[str, float]:
        """Record scalars for `step`; returns the full record (raw +
        ema + throughput). Values may be python numbers or 0-d tensors
        (fetched with float(), which synchronizes with the card)."""
        now = time.perf_counter()
        rec: Dict[str, float] = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            v = float(v)
            rec[k] = v
            e = self._ema.get(k)
            self._ema[k] = v if e is None else (
                self.ema_decay * e + (1.0 - self.ema_decay) * v)
            rec[k + "_ema"] = self._ema[k]
        if self._last_t is not None and step != self._last_step:
            dt = (now - self._last_t) / max(1, step - self._last_step)
            rec["step_ms"] = dt * 1e3
            rec["steps_per_sec"] = 1.0 / dt if dt > 0 else 0.0
            if self.tokens_per_step:
                rec["tokens_per_sec"] = self.tokens_per_step / dt
            if self.flops_per_step and self.peak_flops:
                rec["mfu"] = self.flops_per_step / dt / self.peak_flops
        self._last_t, self._last_step = now, step
        self._n += 1
        self.history.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.print_every and self._n % self.print_every == 0:
            parts = [f"step {step}"] + [
                f"{k} {rec[k + '_ema']:.4g}" for k in scalars]
            if "tokens_per_sec" in rec:
                parts.append(f"{rec['tokens_per_sec']:.3g} tok/s")
            elif "steps_per_sec" in rec:
                parts.append(f"{rec['steps_per_sec']:.3g} it/s")
            print(" | ".join(parts))
        return rec

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Final EMA value per logged key plus total log calls."""
        out = {k + "_ema": v for k, v in self._ema.items()}
        out["n"] = self._n
        return out

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
