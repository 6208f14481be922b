"""The card's power, read by ``nvidia-smi`` every 100 ms in a child process
while a run serves, and integrated over the measured window.

``power.draw`` is the board's reading; it is not the serving stack's
modelled joules (``PhaseStats.*_j`` price an H200 model, not this card).
"""
from __future__ import annotations

import datetime
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

QUERY = "index,timestamp,power.draw,clocks.sm"


def _parse(line: str) -> Optional[Tuple[int, float, float, float]]:
    """(gpu index, epoch seconds, watts, SM MHz) of one csv line, or None."""
    parts = [p.strip() for p in line.split(",")]
    if len(parts) != 4:
        return None
    try:
        stamp = datetime.datetime.strptime(parts[1], "%Y/%m/%d %H:%M:%S.%f").timestamp()
        return int(parts[0]), stamp, float(parts[2]), float(parts[3])
    except ValueError:
        return None


class PowerSampler:
    """Samples every card in ``indices`` from ``start()`` to ``stop()``; the
    child process is ended and waited for in ``stop()``."""

    def __init__(self, indices: Sequence[int] = (0,), interval_ms: int = 100):
        self.indices = list(indices)
        self.interval_ms = interval_ms
        self.samples: List[Tuple[int, float, float, float]] = []
        self._proc = None
        self._reader = None

    def start(self) -> "PowerSampler":
        self._proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader,nounits",
             "-lms", str(self.interval_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        return self

    def _read(self) -> None:
        for line in self._proc.stdout:
            row = _parse(line)
            if row is not None and row[0] in self.indices:
                self.samples.append(row)

    def stop(self) -> None:
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=10)
        self._proc = None

    def window(self, t0: float, t1: float) -> dict:
        """The samples taken in [t0, t1] (epoch seconds): their count, the
        mean summed power of the cards (W) and the mean SM clock (MHz)."""
        per_card = {}
        for idx, stamp, watts, mhz in self.samples:
            if t0 <= stamp <= t1:
                per_card.setdefault(idx, []).append((watts, mhz))
        if len(per_card) != len(self.indices):
            return {"samples": 0}
        mean = lambda xs: sum(xs) / len(xs)
        return {"samples": min(len(v) for v in per_card.values()),
                "power_w": sum(mean([w for w, _ in v]) for v in per_card.values()),
                "sm_mhz": mean([mean([m for _, m in v]) for v in per_card.values()])}
