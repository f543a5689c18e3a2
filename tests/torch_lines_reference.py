"""The JAX package's line path on the port's room drive, on the CPU: the
reference figures for ``chip_smoke.py``'s phase 15. ``detect_lines`` on
each of the first n frames of ``checks.room_drive`` (640×480, grey ÷ 255)
and ``track_lines`` on each consecutive pair with 3-level pyramids: the
valid segments a frame and the tracked segments a pair.

    PYTHONPATH=. python tests/torch_lines_reference.py [n_frames]

Not a test (pytest collects ``test_*.py`` only).
"""

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.frontend import klt
from ground_fusion2_tpu.frontend.lines import detect_lines, track_lines
from ground_fusion2_tpu_torch import checks


def main(n: int = 32) -> dict:
    jax.config.update("jax_platforms", "cpu")
    frames = checks.room_drive(n)
    t0 = time.time()
    valid, tracked = [], []
    prev = None
    for f in frames:
        img = jnp.asarray(f["gray"].astype(np.float32) / 255.0)
        segs, ok = detect_lines(img)
        pyr = tuple(klt.build_pyramid(img, 3))
        valid.append(int(np.asarray(ok).sum()))
        if prev is not None:
            _, ok1 = track_lines(prev[0], pyr, prev[1], prev[2])
            tracked.append(int(np.asarray(ok1).sum()))
        prev = (pyr, segs, ok)
    return dict(valid=valid, tracked=tracked, seconds=time.time() - t0)


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1 else 32)))
