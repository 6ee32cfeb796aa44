"""Per-step progress line for ``fit(verbose=1)`` (a copy of the JAX
package's ``training/progress.py``, which imports no JAX).

The Keras progress bar with a per-step counter and an ETA. The bar fetches
no device values: it tracks the host's dispatch progress and draws the ETA
from the dispatch pace. Exact timing and metrics are the epoch summary
line's job.

On a TTY the line redraws in place (throttled); on a plain stream (CI logs)
it prints a fresh line at a much lower cadence instead of spamming
carriage returns.
"""

from __future__ import annotations

import sys
import time


class ProgressLine:
    """Throttled ``12/400 [=>...] ETA 3s`` line on stdout."""

    def __init__(self, total: int, prefix: str = "", stream=None,
                 width: int = 20):
        self.total = max(int(total), 1)
        self.prefix = prefix
        self.stream = stream if stream is not None else sys.stdout
        self.width = width
        self._isatty = bool(getattr(self.stream, "isatty", lambda: False)())
        self._interval = 0.25 if self._isatty else 10.0
        self._t0 = time.perf_counter()
        # Start the throttle clock now: the final update always draws, so
        # short epochs print exactly one line instead of a step-1 spurious
        # one (perf_counter's arbitrary epoch would otherwise make the
        # first update unconditional).
        self._last_draw = self._t0
        self._drew = False

    def update(self, done: int) -> None:
        now = time.perf_counter()
        if done < self.total and now - self._last_draw < self._interval:
            return
        self._last_draw = now
        elapsed = now - self._t0
        rate = done / elapsed if elapsed > 0 else 0.0
        eta = (self.total - done) / rate if rate > 0 else float("inf")
        filled = self.width * done // self.total
        bar = "=" * filled + ">" * (filled < self.width)
        bar = f"[{bar:<{self.width}}]"
        eta_s = f"{eta:.0f}s" if eta != float("inf") else "?"
        line = (f"{self.prefix}{done}/{self.total} {bar} "
                f"{elapsed:.0f}s elapsed, ETA {eta_s}")
        if self._isatty:
            self.stream.write("\r" + line + "\x1b[K")
        else:
            self.stream.write(line + "\n")
        self.stream.flush()
        self._drew = True

    def close(self) -> None:
        """Clear the in-place line so the epoch summary prints cleanly."""
        if self._drew and self._isatty:
            self.stream.write("\r\x1b[K")
            self.stream.flush()
