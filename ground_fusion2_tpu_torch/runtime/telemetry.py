"""Telemetry: per-stage trajectories + statistics (headless topic surface).

The reference publishes ~30 rviz topics and CSV artifacts (``registerPub``
``visualization.cpp:52-90``; ``printStatistics`` ``:186+``; VIO/wheel/GNSS
CSVs ``:370,545,687``; LIO paths + ``/velocity``/``/text`` HUD feeds
``main_eskf.cpp:331-353``). Without a middleware, the same observability is
a recorder object: every subsystem appends to named pose streams and a
stats ring; ``save()`` writes TUM files per stream + one stats JSONL +
a summary JSON — the artifacts an evaluation pipeline (evo etc.) consumes.

A numpy-only copy of ``ground_fusion2_tpu/runtime/telemetry.py``, kept equal in behaviour
(``tests/test_torch_system.py`` holds the two to the same outputs).
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np


class Telemetry:
    """``max_rows`` bounds every in-memory buffer: long-running systems
    must not grow host lists without limit (r2 advisor finding). When a
    buffer fills, the oldest half is spilled — counters/summary stay
    exact, per-row history keeps the most recent window."""

    def __init__(self, max_rows: int = 200_000):
        self.max_rows = max_rows
        self.streams: dict[str, list] = defaultdict(list)   # name -> rows
        self.stats: list[dict] = []
        self.events: list[dict] = []
        self.counters: dict[str, float] = defaultdict(float)
        self.dropped: dict[str, int] = defaultdict(int)

    def _cap(self, name: str, buf: list):
        if len(buf) >= self.max_rows:
            half = len(buf) // 2
            self.dropped[name] += half
            del buf[:half]

    # ---------------------------------------------------------- inputs
    def pose(self, stream: str, t: float, p, q):
        """Append one pose (TUM row) to a named stream."""
        p = np.asarray(p, float)
        q = np.asarray(q, float)
        buf = self.streams[stream]
        self._cap(stream, buf)
        buf.append((float(t), *p.tolist(), *q.tolist()))

    def tick(self, t: float, **stats):
        """Record one tick's scalar statistics (tracked count, cost, ...)."""
        row = {"t": float(t)}
        for k, v in stats.items():
            row[k] = float(v) if isinstance(v, (int, float, np.floating,
                                                np.integer, bool)) else v
        self._cap("stats", self.stats)
        self.stats.append(row)

    def event(self, t: float, kind: str, **info):
        """Discrete event (switch, reboot, loop closure, gnss align...)."""
        self._cap("events", self.events)
        self.events.append({"t": float(t), "kind": kind, **info})
        self.counters[kind] += 1

    # ---------------------------------------------------------- outputs
    def save(self, out_dir: str):
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for name, rows in self.streams.items():
            with open(out / f"{name}.tum", "w") as f:
                for (t, x, y, z, qw, qx, qy, qz) in rows:
                    f.write(f"{t:.6f} {x:.6f} {y:.6f} {z:.6f} "
                            f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")
        with open(out / "stats.jsonl", "w") as f:
            for row in self.stats:
                f.write(json.dumps(row) + "\n")
        with open(out / "events.jsonl", "w") as f:
            for row in self.events:
                f.write(json.dumps(row) + "\n")
        with open(out / "summary.json", "w") as f:
            f.write(json.dumps(self.summary(), indent=1))

    def summary(self) -> dict:
        """The printStatistics analog: aggregates over the run."""
        s: dict = {"streams": {k: len(v) for k, v in self.streams.items()},
                   "events": dict(self.counters)}
        if self.dropped:
            s["rows_dropped"] = dict(self.dropped)
        if self.stats:
            keys = set().union(*(set(r) for r in self.stats)) - {"t"}
            for k in sorted(keys):
                vals = np.array([r[k] for r in self.stats
                                 if k in r and isinstance(r[k], (int, float))])
                if vals.size:
                    s[k] = {"mean": round(float(vals.mean()), 6),
                            "max": round(float(vals.max()), 6),
                            "last": round(float(vals[-1]), 6)}
        return s
