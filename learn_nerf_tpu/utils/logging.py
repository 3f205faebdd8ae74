"""Training metric logging.

Emits the reference's stdout line format ``step {i}: k=v ...``
(``learn_nerf/scripts/train_nerf.py:130-131``) so ``plot_log`` keeps
working, and adds a throughput counter (rays/sec) the reference lacks
(SURVEY.md section 5).

The reference formats its log line with a blocking ``float()`` per metric
every step — one device->host round trip per metric, each of which
stalls the device queue.  This logger instead

* starts an async host copy of every metric the moment it is logged
  (``copy_to_host_async`` — overlaps the transfer with the next step's
  compute), and
* prints each step's line one step late, by which time the values are
  already host-resident and formatting costs nothing.

Call :meth:`MetricLogger.flush` after the loop to emit the final line.
"""

import sys
import time
from typing import Dict, Optional, Tuple


class MetricLogger:
    def __init__(self, rays_per_step: Optional[int] = None, out=None):
        self.rays_per_step = rays_per_step
        self.out = out if out is not None else sys.stdout
        self._last_time: Optional[float] = None
        self._ema_rate: Optional[float] = None
        self._pending: Optional[Tuple[int, Dict[str, object], Optional[float]]] = None

    def log_step(self, step: int, values: Dict[str, object]) -> None:
        for v in values.values():
            if hasattr(v, "copy_to_host_async"):
                v.copy_to_host_async()

        # The inter-call interval is the per-step wall time (measured at the
        # producing step, attached to its own line when it prints).
        now = time.monotonic()
        rate = None
        if self.rays_per_step is not None and self._last_time is not None:
            dt = now - self._last_time
            if dt > 0:
                rate = self.rays_per_step / dt
                self._ema_rate = (
                    rate
                    if self._ema_rate is None
                    else 0.9 * self._ema_rate + 0.1 * rate
                )
        self._last_time = now

        pending, self._pending = self._pending, (step, values, self._ema_rate)
        if pending is not None:
            self._emit(*pending)

    def flush(self) -> None:
        """Print the deferred final line (call once after the loop)."""
        if self._pending is not None:
            self._emit(*self._pending)
            self._pending = None

    def _emit(
        self, step: int, values: Dict[str, object], ema_rate: Optional[float]
    ) -> None:
        parts = [f"{k}={float(v):.05}" for k, v in values.items()]
        if ema_rate is not None:
            parts.append(f"rays_per_sec={ema_rate:.05}")
        print(f"step {step}: {' '.join(parts)}", file=self.out, flush=True)
