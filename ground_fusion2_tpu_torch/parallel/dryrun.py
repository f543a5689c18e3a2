"""Process groups for the distributed solvers, spawned ranks, and the
multi-rank dry run (the port of ``__graft_entry__.py:21
dryrun_multichip``).

``process_group`` opens a ``torch.distributed`` group over a ``FileStore``
under a directory the caller names and destroys it on exit (gloo on the
CPU, NCCL on the card). ``run_ranks`` starts one spawned process a rank,
joins each within a deadline and kills every rank when one is missed, so a
rendezvous that hangs fails instead of hanging its caller. The per-rank
bodies (``window_rank``, ``mapping_rank``, both in ``solvers_rank``) run
the two solvers on a rank's shard of a whole problem the caller hands
every rank.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import VioConfig
from ..core.device import resolve
from ..vio.state import WindowLayout
from . import dist_ba, dist_mapping


@contextlib.contextmanager
def process_group(backend: str, rank: int, world: int, store_dir: str):
    """The default process group of ``world`` ranks over a FileStore in
    ``store_dir``; yields ``dist.group.WORLD`` and destroys it on exit."""
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _rank_entry(fn, rank, world, backend, store_dir, args):
    if backend == "nccl":
        torch.cuda.set_device(rank)
    with process_group(backend, rank, world, store_dir) as group:
        out = fn(group, rank, world, *args)
    torch.save(out, os.path.join(store_dir, f"rank{rank}.pt"))


def run_ranks(fn, world: int, backend: str = "gloo", args=(),
              timeout: float = 300.0) -> list:
    """``fn(group, rank, world, *args)`` on ``world`` spawned ranks; their
    return values in rank order. Raises if a rank fails, and kills every
    rank and raises when they have not all ended within ``timeout``
    seconds."""
    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="gf2_ranks_")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, backend, store_dir, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise TimeoutError(f"ranks {late} of {world} still running after "
                               f"{timeout} s (a hung rendezvous?)")
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if bad:
            raise RuntimeError(f"ranks failed (exit codes {bad})")
        return [torch.load(os.path.join(store_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)


def _rank_device(device) -> torch.device:
    """``device`` for this rank: its own card (set by ``_rank_entry``) for
    CUDA."""
    dev = resolve(device)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def window_rank(group, rank, world, x, meas, cfg: VioConfig, iters: int,
                device: str = "cuda"):
    """One rank of :func:`dist_ba.make_distributed_solver` on its shard of
    the whole window (x, meas): (its p, q, rho on the CPU, the cost)."""
    dev = _rank_device(device)
    xs, ms = dist_ba.shard_window(x, meas, rank, world)
    solve = dist_ba.make_distributed_solver(
        group, WindowLayout(x.rho.shape[0], x.p.shape[0]), cfg, iters, dev)
    out, cost = solve(xs, ms)
    return dict(p=out.p.cpu(), q=out.q.cpu(), rho=out.rho.cpu(),
                cost=float(cost))


def mapping_rank(group, rank, world, prob, halo: int, iters: int,
                 device: str = "cuda"):
    """One rank of :func:`dist_mapping.make_mapping_solver` on its shard of
    the whole problem: (its p, q, rho on the CPU, the cost)."""
    dev = _rank_device(device)
    K = prob.kf_p.shape[0]
    solve = dist_mapping.make_mapping_solver(group, K, halo, iters, device=dev)
    p, q, rho, cost = solve(dist_mapping.shard_problem(prob, rank, world))
    return dict(p=p.cpu(), q=q.cpu(), rho=rho.cpu(), cost=float(cost))


def solvers_rank(group, rank, world, window=None, mapping=None,
                 device: str = "cuda"):
    """Both bodies on one rank: ``window`` = (x, meas, cfg, iters) for
    :func:`window_rank`, ``mapping`` = (prob, halo, iters) for
    :func:`mapping_rank` (either None to skip it)."""
    out = {}
    if window is not None:
        out["window"] = window_rank(group, rank, world, *window, device)
    if mapping is not None:
        out["mapping"] = mapping_rank(group, rank, world, *mapping, device)
    return out


def _dryrun_rank(group, rank, world, device):
    from .. import checks
    F = 16 * world
    x0, feats, layout, _ = checks.example_window(F, "cpu")
    meas = checks.example_measurements(x0, feats, layout, "cpu")
    prob, _ = dist_mapping.make_mapping_problem(4 * world, lpk=8, halo=2,
                                                seed=0, perturb=0.02)
    out = solvers_rank(group, rank, world,
                       (x0, meas, VioConfig(num_feats=F), 2), (prob, 2, 2),
                       device)
    finite = all(bool(torch.isfinite(o["p"]).all()) for o in out.values())
    return dict(window=out["window"]["cost"], mapping=out["mapping"]["cost"],
                finite=finite)


def dryrun_multichip(n: int, device: str = "cuda") -> None:
    """One distributed window step (F = 16·n, 2 LM iterations) and one
    mapping solve (K = 4·n, 8 landmarks a keyframe, halo 2) on n ranks:
    NCCL with one card a rank on ``cuda`` (raises with fewer than n cards),
    gloo on the CPU. Prints the two costs."""
    if torch.device(device).type == "cuda":
        resolve(device)
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"dryrun_multichip({n}) needs {n} CUDA "
                               f"devices, found {torch.cuda.device_count()}")
        backend = "nccl"
    else:
        backend = "gloo"
    out = run_ranks(_dryrun_rank, n, backend, args=(device,))
    if not all(o["finite"] for o in out):
        raise RuntimeError("dryrun_multichip: a non-finite result")
    print(f"dryrun_multichip({n}): ok, window cost={out[0]['window']:.3f}, "
          f"mapping cost={out[0]['mapping']:.4f}")
