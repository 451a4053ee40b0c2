"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, entry,
reference or per-layer metric sits in a file of its own, so a new cell
needs new files and new ``BENCHMARK.json`` entries only:

- a configuration: the ``file`` its ``configs`` entry names (JSON);
- a traffic mix: ``traffic/<traffic>.json``;
- an entry into the program: ``entries/<config's "entry">.py``;
- a plain reference: ``reference/<config's "reference">.py``;
- a per-layer metric: ``metrics/<metric name>.py``.
"""

import importlib.util
import json
import pathlib
import re

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]


def _load_py(path, kind):
    """Import the file ``path`` as a module of its own name."""
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    name = "portbench_" + kind + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with its configuration and traffic read.

    ``config`` and ``traffic`` are the two files' objects; ``end_to_end``
    and ``per_layer`` are the metric entries of ``BENCHMARK.json`` that
    this cell reports."""

    def __init__(self, bench, entry):
        self.bench = bench
        self.name = entry["name"]
        self.chips = entry["chips"]
        conf = next((c for c in bench.spec["configs"]
                     if c["name"] == entry["config"]), None)
        if conf is None:
            raise KeyError(f"cell {self.name}: no configuration "
                           f"{entry['config']!r}")
        self.config = json.loads((bench.root / conf["file"]).read_text())
        self.traffic = json.loads(
            (bench.dir / "traffic" / f"{entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench.spec["end_to_end"]
                           if self.name in m.get("workloads", [self.name])]
        self.per_layer = [m for m in bench.spec["per_layer"]
                          if self.name in m.get("workloads", [self.name])]

    @property
    def pairs_per_call(self):
        return int(self.traffic["pairs_per_call"])

    @property
    def shape(self):
        """(H, W) of one image of a pair."""
        return (int(self.config["image"]["height"]),
                int(self.config["image"]["width"]))

    def entry(self):
        return self.bench.module("entries", self.config["entry"])

    def reference(self):
        return self.bench.module("reference", self.config["reference"])


class Bench:
    """``BENCHMARK.json`` at ``root`` and the benchmark's folder ``dir``
    (default: the folder this harness lies in, and its parent)."""

    def __init__(self, root=None, bench_dir=None):
        self.dir = pathlib.Path(bench_dir or BENCH_DIR)
        self.root = pathlib.Path(root or self.dir.parent)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules = {}

    def cell(self, name):
        entry = next((w for w in self.spec["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return Cell(self, entry)

    def module(self, kind, name):
        key = (kind, name)
        if key not in self._modules:
            self._modules[key] = _load_py(self.dir / kind / f"{name}.py",
                                          kind)
        return self._modules[key]

    def hand_kernels(self):
        """Names of the hand-written kernels, from every per-layer
        metric's reader that declares ``KERNELS``: the device time that
        is not theirs and not a copy is glue."""
        names = []
        for m in self.spec["per_layer"]:
            names += getattr(self.module("metrics", m["name"]), "KERNELS",
                             ())
        return tuple(dict.fromkeys(names))
