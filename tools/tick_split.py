"""Phases 5 and 8 of ``chip_smoke.py`` alone, on the card, for one or more
trees of the port: the LiDAR drive (``LidarOdometry(m3dgr_lio())`` over 60
scans: its figures, and the LiDAR tick's launches and device ms by kernel
over the last 3 ticks), then the system drive (``checks.system_drive(40)``)
through ``GroundFusion(m3dgr_system())`` and torch.profiler's split of the
last 3 system ticks: device ms by class (the port's kernels, torch.linalg,
other), by kernel, and by profiler range (``utils/profiling.py stage``,
named after the JAX function each stretch ports), with the launches and
the synchronizing calls a tick by call site.

    PYTHONPATH=. python3 tools/tick_split.py [--out DIR] [ROOT[:TAG] ...]

Each ROOT (default ``.``) is a checkout of the repo; its
``ground_fusion2_tpu_torch`` is imported in a process of its own and its
``csrc/`` built there. Trees are run in the order given (run a parent, the
change, the change, the parent to compare them within one call). Each
split goes to ``DIR/tick_split_<TAG>_<i>.json`` and its printout to
``DIR/tick_split_<TAG>_<i>.log`` (DIR default ``out``); the last line
printed is the list of {tag, median tick ms, device ms a tick, launches a
tick, syncs a tick, the LiDAR tick's launches and device ms in phases 5
and 8, and phases 5's and 8's summary lines up to their launch counts}. A tree whose CT-ICP launches Y's standalone solve
(no ``ct_icp.normal_solve``) is held to that route in phase 5, and one
whose CT-ICP launches AK around D and E (no ``ct_icp.assoc_weights``) to
AK's 13 launches a LiDAR tick.
"""

import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def one(root: str, tag: str, index: int, out_dir: str) -> dict:
    import collections
    import importlib.util
    root = str(pathlib.Path(root).resolve())
    sys.path.insert(0, root)
    # this tree's chip_smoke.py (its split), the port of ROOT
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    assert _kernels.__file__.startswith(root), _kernels.__file__
    if not torch.cuda.is_available():
        raise SystemExit("tools/tick_split.py needs a CUDA device")
    csrc = pathlib.Path(root) / "ground_fusion2_tpu_torch" / "csrc"
    have = {n for n, (src, _) in cs.SOURCES.items() if (csrc / src).exists()}
    cs.CAMERA_KERNELS = tuple(k for k in cs.CAMERA_KERNELS if k in have)
    cs.LIDAR_KERNELS = tuple(k for k in cs.LIDAR_KERNELS if k in have)
    cs.PKG = str(csrc) + "/"
    from ground_fusion2_tpu_torch.lio import ct_icp
    if not hasattr(ct_icp, "assoc_weights"):
        # AK's launches around D and E: the keypoints, 6 weights, 5 steps
        # and the scan
        cs.LIO_AK_PER_TICK = 13
    if not hasattr(ct_icp, "normal_solve"):
        # Y's own launch after each E: its route then
        cs.LIO_PATH_KERNELS = tuple(k for k in cs.LIO_PATH_KERNELS
                                    if k != "ct_icp_solve") + ("icp_solve",)
        cs.LIO_OFF_PATH = ()
        cs.LIDAR_KERNELS = tuple(k for k in cs.LIDAR_KERNELS
                                 if k != "ct_icp_solve") + ("icp_solve",)
    _kernels.build(force=True)
    _kernels.library()
    got = {}
    split = cs.device_split

    def keep(prof, n):
        got.update(split(prof, n))
        return got
    cs.device_split = keep
    sites = collections.Counter()
    show = cs.sync_site

    def counting(counter):
        f = show(counter)

        def g(*a, **k):
            f(*a, **k)
            sites.clear()
            sites.update(counter)
        return g
    cs.sync_site = counting
    lidar = {}
    line = cs.lidar_split_line

    def keep_line(what, split, card, ranges=False):
        fig = line(what, split, card, ranges)
        lidar["phase 8" if ranges else "phase 5"] = fig
        return fig
    cs.lidar_split_line = keep_line
    err5 = cs.lidar_main_path(torch.device(cs.DEVICE), cs.card_line())[0]
    frames = checks.system_drive(cs.SYS_FRAMES)
    err, launches, median = cs.system_main_path(torch.device(cs.DEVICE),
                                                cs.card_line(), frames)[:3]
    err = err5 or err
    out = dict(tag=tag, root=root, error=err, median_tick_ms=median,
               device_ms_per_tick=got.get("device_ms_per_tick"),
               launches_per_tick=got.get("launches_per_tick"),
               syncs_last_tick=dict(sites), lidar_tick=lidar, split=got,
               card=cs.card_line())
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(out_dir) / f"tick_split_{tag}_{index}.json").write_text(
        json.dumps(out, indent=1))
    return out


def main(args) -> int:
    if len(args) >= 5 and args[0] == "--one":
        print("TICK_SPLIT " + json.dumps(one(args[1], args[2], int(args[3]),
                                             args[4])), flush=True)
        return 0
    out_dir = "out"
    if args[:1] == ["--out"]:
        out_dir, args = args[1], args[2:]
    trees = args or ["."]
    rows = []
    for i, t in enumerate(trees):
        root, _, tag = t.partition(":")
        tag = tag or pathlib.Path(root).resolve().name
        env = dict(os.environ, PYTHONPATH=str(pathlib.Path(root).resolve()))
        res = subprocess.run([sys.executable, __file__, "--one", root, tag,
                              str(i), out_dir], capture_output=True,
                             text=True, env=env, timeout=900)
        pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
        (pathlib.Path(out_dir) / f"tick_split_{tag}_{i}.log").write_text(
            res.stdout + res.stderr)
        sys.stdout.write(res.stdout[-4000:])
        sys.stderr.write(res.stderr[-4000:])
        summary = {k: next((ln.split(", launches")[0] for ln in
                            res.stdout.splitlines() if ln.startswith(k)),
                           None) for k in ("lidar path:", "system path:")}
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("TICK_SPLIT ")]
        if res.returncode or not line:
            print(f"tick_split: {root} failed ({res.returncode})", flush=True)
            return 1
        r = json.loads(line[-1][len("TICK_SPLIT "):])
        rows.append(dict(tag=tag, error=r["error"],
                         median_tick_ms=r["median_tick_ms"],
                         device_ms_per_tick=r["device_ms_per_tick"],
                         launches_per_tick=r["launches_per_tick"],
                         syncs_last_tick=r["syncs_last_tick"],
                         lidar_tick=r["lidar_tick"], **summary))
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
