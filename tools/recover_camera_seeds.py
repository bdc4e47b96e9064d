"""examples/recover_camera.py at its own setting through the vpt_torch port,
run N times on one NVIDIA GPU with every FD step's seed shifted by 0,
100000, 200000, ...: how far the recovered camera depends on the draws.

The run itself is chip_smoke.py's phase-18 recover_camera (its RC_*
setting); this script only wraps make_fd_geom_train_step so each step sees
its seed plus the run's offset. Offset 0 is phase 18's run.

Usage:  python3 tools/recover_camera_seeds.py [N]      (N = 4 by default)
"""
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402
import vpt_torch  # noqa: E402
from vpt_torch.kernels import _build  # noqa: E402


def with_seed_offset(make, offset: int):
    """`make` (make_fd_geom_train_step) whose steps add `offset` to their
    seed."""
    def made(*args, **kw):
        step = make(*args, **kw)
        return lambda theta, target, seed: step(theta, target, seed + offset)
    return made


def main(n: int = 4) -> int:
    if not torch.cuda.is_available():
        sys.exit("recover_camera_seeds: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    _build.load()
    dev = torch.device("cuda", 0)
    camera = vpt_torch.default_camera()
    make = vpt_torch.dist.make_fd_geom_train_step
    runs = []
    try:
        for i in range(n):
            vpt_torch.dist.make_fd_geom_train_step = with_seed_offset(
                make, 100000 * i)
            print(f"seed offset {100000 * i}:", flush=True)
            runs.append(dict(seed_offset=100000 * i,
                             **chip_smoke.recover_camera(camera, card, dev)))
    finally:
        vpt_torch.dist.make_fd_geom_train_step = make
    print(json.dumps({"recover_camera": runs, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
