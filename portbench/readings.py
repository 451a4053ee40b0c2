"""The readings a cell's correctness limit is set from, on the card.

    python3 portbench/readings.py --workload <cell> --seeds <n> --control <m>
        [--seconds <s>] [--first-seed <k>] [--faults]

from the root of a checkout, in one process (the set-up is paid once):

- the program: ``--seeds`` runs of the cell with a short window of
  ``--seconds``, each on its own seed, and the number each run compares
  (the worst map's share of pixels that differ from the reference);
- the control: on ``--control`` seeds, the reference computed one
  precision step below the configuration's (bfloat16 for float32) put in
  the program's place, on the inputs a run would check;
- with ``--faults``, each fault of the timed path that the cell can have,
  planted in the port's matcher (``harness/faults.py``), on ``--control``
  seeds.

Prints one JSON line a reading and a summary line. The benchmark's own
runs never run this.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness import core, scenes, spec  # noqa: E402
from portbench.harness.faults import FAULTS, plant  # noqa: E402


def control(cell, seed, dev):
    """The reference one precision step below the configuration's, held
    to the reference, on the inputs of a run's first ``check_calls``
    calls of seed ``seed``."""
    H, W = cell.shape
    scene_rng, _ = core.rngs(seed)
    pool = scenes.pool(scene_rng, W, H, cell.traffic["scene"],
                       int(cell.traffic["pool_pairs"]),
                       cell.pairs_per_call)
    items = pool[:int(cell.traffic["check_calls"])]
    one = cell.pairs_per_call == 1
    lefts = np.concatenate([a[None] if one else a for a, _ in items])
    rights = np.concatenate([b[None] if one else b for _, b in items])
    ref = cell.reference()
    want = ref.disparity(cell.config, lefts, rights, dev)
    low = ref.disparity(cell.config, lefts, rights, dev,
                        dtype=torch.bfloat16)
    return core.worst_map_mismatch_pct(low, want), len(want)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2_000_000_000)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Bench(ROOT).cell(args.workload)
    dev = "cuda:0"
    emit = lambda rec: print(json.dumps(rec), flush=True)  # noqa: E731
    program, low = [], []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t = time.perf_counter()
        r = core.run(cell, seed, args.seconds, False, dev, t)
        v = r["checks"]["mismatch_pct"]["value"]
        program.append(v)
        emit({"workload": cell.name, "reading": "program", "seed": seed,
              "mismatch_pct": v, "correct": r["correct"],
              "metrics": {m: x["value"] for m, x in r["metrics"].items()},
              "s": time.perf_counter() - t})
    for k in range(args.control):
        seed = args.first_seed + 104729 * (k + 1)
        t = time.perf_counter()
        v, maps = control(cell, seed, dev)
        low.append(v)
        emit({"workload": cell.name, "reading": "control_bf16",
              "seed": seed, "mismatch_pct": v, "maps": maps,
              "s": time.perf_counter() - t})
    faults = {}
    for name in (FAULTS if args.faults else ()):
        for k in range(args.control):
            mend = plant(cell, name)
            if mend is None:
                break
            seed = args.first_seed + 15485863 * (k + 1)
            try:
                r = core.run(cell, seed, args.seconds, False, dev,
                             time.perf_counter())
            finally:
                mend()
            v = r["checks"]["mismatch_pct"]["value"]
            faults.setdefault(name, []).append(v)
            emit({"workload": cell.name, "reading": f"fault_{name}",
                  "seed": seed, "mismatch_pct": v,
                  "correct": r["correct"]})
    emit({"workload": cell.name, "summary": True,
          "program_max": max(program) if program else None,
          "control_min": min(low) if low else None,
          "faults_min": {k: min(v) for k, v in faults.items()},
          "limit": cell.config["limits"]["mismatch_pct"],
          "card": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
