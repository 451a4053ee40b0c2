#!/usr/bin/env python3
"""Times the SGM (K2) and GSW (K3) kernels of two checkouts on one card,
in turns.

    python3 kernel_compare.py OTHER_CHECKOUT [--rounds N]

OTHER_CHECKOUT is another checkout of this repository (for example the
parent commit unpacked with ``git archive``). Worker processes run in the
order other, this, this, other (N rounds of it); each imports
``simplestereo_tpu_torch`` from its own checkout, builds its kernels there
and times, with CUDA events (median over distinct inputs, the first call
excluded):

- ``sgm_cuda.aggregate`` at 1280x720, D = 128 and at 384x288, D = 16,
  8 paths, on seeded integer cost volumes (the recurrence's time does not
  depend on the values);
- ``gsw_cuda._gsw_pass`` at 384x288 and 1280x720, win 23, d 4..14,
  gamma 12.5, fMax 20, both matching directions (the StereoGSW main point),
  on seeded noise pairs with a shift of 5.

Each worker prints one JSON line; the last lines are the card's name and
power limit and a summary (the better of each checkout's runs). Needs a
CUDA card and nvcc; imports no JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

SGM_SHAPES = [(720, 1280, 128), (288, 384, 16)]
GSW_SHAPES = [(288, 384), (720, 1280)]
GSW_KW = dict(win_size=23, min_disp=4, max_disp=14, gamma=12.5, f_max=20.0)


def worker():
    sys.path.insert(0, str(Path.cwd()))
    import numpy as np
    import torch

    from chip_smoke import cuda_ms  # blocks JAX, as the port must run
    from simplestereo_tpu_torch.passive import gsw_cuda, sgm_cuda

    dev = torch.device("cuda", 0)

    def events(fn, inputs):
        return cuda_ms(fn, inputs)[0]

    out = {"checkout": str(Path.cwd())}
    rng = np.random.default_rng(0)
    for h, w, D in SGM_SHAPES:
        vols = [torch.tensor(rng.integers(0, 60, (h, w, D), np.int32),
                             dtype=torch.float32, device=dev)
                for _ in range(4)]
        out[f"sgm_{w}x{h}_D{D}"] = events(
            lambda C: sgm_cuda.aggregate(C, 36.0, 144.0, 8), vols)
        del vols
        torch.cuda.empty_cache()
    for h, w in GSW_SHAPES:
        left = np.random.default_rng(0).integers(0, 256, (h, w, 3), np.uint8)
        planes = []
        for i in range(6):
            li = np.roll(left, i, axis=0)
            refs, tgts = gsw_cuda._directions(
                torch.tensor(li[None], device=dev),
                torch.tensor(np.roll(li, -5, axis=1)[None], device=dev), True)
            planes.append(gsw_cuda._build_planes(refs, tgts,
                                                 GSW_KW["win_size"]))
        out[f"gsw_{w}x{h}"] = events(
            lambda p: gsw_cuda._gsw_pass(p, H=h, W=w, **GSW_KW), planes)
        del planes
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker()
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_compare: needs a CUDA card")
    args = sys.argv[1:]
    rounds = 1
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    if len(args) != 1:
        sys.exit(__doc__)
    other, this = Path(args[0]).resolve(), Path(__file__).resolve().parent
    runs = {str(other): [], str(this): []}
    for _ in range(rounds):
        for root in (other, this, this, other):
            res = subprocess.run(
                [sys.executable, str(this / "kernel_compare.py"), "--worker"],
                cwd=root, capture_output=True, text=True, check=True,
                timeout=900)
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[str(root)].append(json.loads(line))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    summary = {}
    for root, rs in runs.items():
        keys = [k for k in rs[0] if k != "checkout"]
        summary[root] = {k: min(r[k] for r in rs) for k in keys}
    print(json.dumps({"best_ms": summary, "card": card}))


if __name__ == "__main__":
    main()
