"""Progress on stderr for long sweeps and scans, the port's copy of
``vuke_tpu/progress.py``: position, rate, elapsed time and a message,
throttled, and silent unless the stream is a TTY."""

from __future__ import annotations

import sys
import time
from typing import Optional


class Progress:
    def __init__(self, total: Optional[int] = None, label: str = "",
                 stream=None, min_interval: float = 0.5, enabled: Optional[bool] = None):
        self.total = total
        self.label = label
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval = min_interval
        self.pos = 0
        self.t0 = time.time()
        self._last = 0.0
        self.message = ""
        if enabled is None:
            enabled = hasattr(self.stream, "isatty") and self.stream.isatty()
        self.enabled = enabled

    def advance(self, n: int):
        self.pos += n
        now = time.time()
        if self.enabled and now - self._last >= self.min_interval:
            self._last = now
            self._render()

    def set_message(self, msg: str):
        self.message = msg

    def _render(self):
        elapsed = time.time() - self.t0
        rate = self.pos / elapsed if elapsed > 0 else 0.0
        if self.total:
            pct = 100.0 * self.pos / self.total
            line = (f"\r{self.label} {self.pos}/{self.total} ({pct:.1f}%) | "
                    f"{rate:,.0f}/s | {elapsed:.0f}s {self.message}")
        else:
            line = (f"\r{self.label} {self.pos} | {rate:,.0f}/s | "
                    f"{elapsed:.0f}s {self.message}")
        self.stream.write(line[:160])
        self.stream.flush()

    def finish(self):
        if self.enabled:
            self._render()
            self.stream.write("\n")
            self.stream.flush()
