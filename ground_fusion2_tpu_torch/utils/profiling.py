"""Per-stage timing (port of ``ground_fusion2_tpu/utils/profiling.py``; the
reference's ``zjloc::common::Timer::Evaluate`` and ``TicToc``).

Device-aware: before the clock stops, the devices of the CUDA tensors a
stage returns (or that ``block_on`` names) are synchronized, so a time
covers the work the stage queued and not its launch alone.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block_until_ready(tree):
    """Wait for the CUDA devices that hold tensors of ``tree`` (tensors,
    or lists, tuples, NamedTuples and dicts of them) to finish their
    queued work; a tree on the CPU returns at once."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


class Timer:
    def __init__(self):
        self.records: dict[str, list[float]] = defaultdict(list)

    @contextmanager
    def time(self, label: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        self.records[label].append(time.perf_counter() - t0)

    def evaluate(self, fn, label: str):
        """Timer::Evaluate(lambda, label): run fn, record, return result."""
        t0 = time.perf_counter()
        out = fn()
        block_until_ready(out)
        self.records[label].append(time.perf_counter() - t0)
        return out

    def summary(self) -> str:
        lines = []
        for label, ts in sorted(self.records.items()):
            n = len(ts)
            mean = sum(ts) / n * 1e3
            mx = max(ts) * 1e3
            lines.append(f"{label:32s} n={n:5d} mean={mean:8.3f} ms "
                         f"max={mx:8.3f} ms total={sum(ts):7.2f} s")
        return "\n".join(lines)

    def dump(self, path: str):
        """Timer::DumpIntoFile equivalent."""
        with open(path, "w") as f:
            f.write(self.summary() + "\n")


GLOBAL_TIMER = Timer()


STAGE_PREFIX = "gf2::"


def stage(name: str):
    """A torch.profiler range ``gf2::<name>`` around a stretch of a tick,
    named after the JAX function it ports (``_tracker_step``,
    ``solve_window``, ``lidar_tick``, ...). A trace attributes each CUDA
    activity to the innermost range open when it was launched
    (``chip_smoke.py``'s split by range); with no profiler running a range
    costs about a microsecond of host time."""
    return torch.profiler.record_function(STAGE_PREFIX + name)
