"""The JAX package's keyframe-sharded mapping solve on one CPU device: the
reference figures for ``chip_smoke.py``'s phase 16.
``make_mapping_problem(K, lpk, halo=3, seed=1, pix_noise=0, perturb=0.05)``
(``tests/test_dist_mapping.py``'s draws) at ``tools/bench_weak_scaling.py``'s
widths, solved by ``make_mapping_solver`` for each iteration count given:
the largest pose error to the truth (m) and the final cost.

    PYTHONPATH=. python tests/torch_parallel_reference.py [K lpk iters...]

Not a test (pytest collects ``test_*.py`` only).
"""

import json
import sys
import time

import numpy as np

import jax
from jax.sharding import Mesh

from ground_fusion2_tpu.parallel.dist_mapping import (
    make_mapping_problem, make_mapping_solver)


def main(K: int = 64, lpk: int = 128, iters=(6,)) -> dict:
    jax.config.update("jax_platforms", "cpu")
    prob, (gt_p, _, _) = make_mapping_problem(K, lpk, 3, seed=1,
                                              pix_noise=0.0, perturb=0.05)
    mesh = Mesh(np.array(jax.devices()[:1]), ("k",))
    out = {}
    for n in iters:
        t0 = time.time()
        p, q, rho, cost = make_mapping_solver(mesh, K, 3, iters=n)(prob)
        err = float(np.linalg.norm(np.asarray(p) - gt_p, axis=1).max())
        out[n] = dict(max_pose_err=err, cost=float(cost),
                      seconds=time.time() - t0)
    return dict(K=K, lpk=lpk, halo=3, runs=out)


if __name__ == "__main__":
    a = [int(v) for v in sys.argv[1:]]
    print(json.dumps(main(*a[:2], iters=tuple(a[2:]) or (6,)) if a
                     else main()))
