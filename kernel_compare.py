#!/usr/bin/env python3
"""Times the SGM (K2), GSW (K3), IIR unwrapping (S1) and WLS line-solve
(S2) kernels of two checkouts on one card, in turns.

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
  on seeded noise pairs with a shift of 5;
- ``unwrapping._iir_unwrap`` (tau 1) on wrapped phases of FTP's 1248x688
  (the shape ``getCloud`` hands ``infiniteImpulseResponse`` at 1280x720)
  and of 1280x720, float32 and float64;
- ``wls._solve``: the row and the column solve of the SGM preset's WLS at
  1280x720 (lambda_t of the first of 3 iterations at lambda 2; weights
  of a noise guide at sigma 8; 5% zero-confidence markers).

S1 and S2 are also timed queued behind a sleep on the stream (``_queued``:
the device's time a call, without the host's dispatch, which a lone
call's events hold too). Each worker prints one JSON line; the last lines
are the card's name and power limit and a summary (the better of each
checkout's runs). Needs a CUDA card and nvcc; imports no JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

SGM_SHAPES = [(720, 1280, 128), (288, 384, 16)]
IIR_SHAPES = [(688, 1248), (720, 1280)]
GSW_SHAPES = [(288, 384), (720, 1280)]
GSW_KW = dict(win_size=23, min_disp=4, max_disp=14, gamma=12.5, f_max=20.0)


def wrapped_phase(h, w, dtype, seed):
    """A wrapped phase map: a tilted plane, a bump and noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    phi = 0.21 * x + 0.13 * y + 3 * np.exp(
        -((x - w / 2) ** 2 + (y - h / 2) ** 2) / (0.1 * (h * w + 1)))
    phi += rng.normal(0, 0.2, (h, w))
    return np.angle(np.exp(1j * phi)).astype(dtype)


def wls_inputs(h, w, seed, dev):
    """(conf, wx, wy, u) of one frame as the smoother builds them: noise
    guide weights at sigma 8, disparities around 20, 5% markers."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    d = rng.normal(20, 5, (1, h, w)).astype(np.float32)
    conf = (rng.random((1, h, w)) >= 0.05).astype(np.float32)
    g = rng.integers(0, 256, (1, h, w, 3)).astype(np.float32)
    dx = np.abs(np.diff(g, axis=2)).sum(-1)
    dy = np.abs(np.diff(g, axis=1)).sum(-1)
    t = [torch.tensor(a, device=dev) for a in
         (conf, np.exp(-dx / 8).astype(np.float32),
          np.exp(-dy / 8).astype(np.float32), d * conf)]
    return t


def worker():
    sys.path.insert(0, str(Path.cwd()))
    import numpy as np
    import torch

    from chip_smoke import cuda_ms, queued_ms  # blocks JAX, as the port must
    from simplestereo_tpu_torch import unwrapping
    from simplestereo_tpu_torch.passive import gsw_cuda, sgm_cuda, wls

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
    for h, w in IIR_SHAPES:
        for dtype in (np.float32, np.float64):
            phases = [torch.tensor(wrapped_phase(h, w, dtype, i),
                                   device=dev) for i in range(6)]
            fn = lambda x: unwrapping._iir_unwrap(x, 1.0)  # noqa: E731
            out[f"s1_{w}x{h}_{dtype.__name__}"] = events(fn, phases)
            out[f"s1_{w}x{h}_{dtype.__name__}_queued"] = queued_ms(fn, phases)
    lam_t = wls._lam_schedule(2.0, 3, 1)
    stacks = [wls_inputs(720, 1280, i, dev) for i in range(6)]
    for name, along_y in (("row", False), ("column", True)):
        fn = lambda x: wls._solve(  # noqa: E731
            x[0], x[2 if along_y else 1], x[3], lam_t, along_y)
        out[f"s2_{name}_1280x720"] = events(fn, stacks)
        out[f"s2_{name}_1280x720_queued"] = queued_ms(fn, stacks)
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
