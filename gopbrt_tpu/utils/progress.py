"""Progress reporting (counterpart of pkg/pbrt/progress.go StdoutProgress).

The reference runs a channel-fed goroutine printing ``\rProgress: %`` with
start/end timestamps (progress.go:10-61).  Here progress is a host-side
callback between device passes (there is no progress inside a pass — a
pass is one XLA program).
"""

from __future__ import annotations

import sys
import time


class StdoutProgress:
    """Prints carriage-return progress + start/end/duration like
    progress.go:33-56."""

    def __init__(self, label: str = "render"):
        self.label = label
        self.t0 = None

    def __call__(self, done: int, total: int) -> None:
        if self.t0 is None:
            self.t0 = time.time()
            print(f"[{self.label}] start {time.strftime('%H:%M:%S')}")
        pct = 100.0 * done / max(total, 1)
        sys.stdout.write(f"\r[{self.label}] progress: {pct:5.1f}%")
        sys.stdout.flush()
        if done >= total:
            dt = time.time() - self.t0
            print(f"\n[{self.label}] done in {dt:.2f}s")


class NullProgress:
    def __call__(self, done: int, total: int) -> None:  # pragma: no cover
        pass
