"""Find a cell's pieces by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix. The configuration is
``configs/<name>.json`` (its ``family`` names a generator in
``inputs/<family>.py``), the mix is ``traffic/<name>.json`` (its ``loop``
names ``loops/<loop>.py``), and each metric is read by
``metrics/<metric>.py``. Nothing here knows any one of them, so a cell,
a configuration, a mix or a metric is added by adding files and entries.
"""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent   # the benchmark's folder


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, prefix):
    """A Python file loaded under a name of its own (file names such as
    ``dispatch_ms.stream.py`` are not importable by ``import``)."""
    path = Path(path)
    name = prefix + "_" + "".join(c if c.isalnum() else "_"
                                  for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names, read from the
    benchmark folder ``here`` and its ``BENCHMARK.json`` in ``root``."""

    def __init__(self, name, root, here=HERE):
        self.root = Path(root)
        self.here = Path(here)
        self.bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(one of {sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(self.root / self.config_entry["file"])
        self.traffic = load_json(
            self.here / "traffic" / f"{self.workload['traffic']}.json")

    def applies(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def metrics(self, trace):
        """The cell's metrics of one kind: end-to-end for an untraced
        run, per-layer for a traced one."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key] if self.applies(m)]

    def loop(self):
        return load_module(self.here / "loops" / f"{self.traffic['loop']}.py",
                           "bench_loop")

    def family(self):
        return load_module(
            self.here / "inputs" / f"{self.config['family']}.py",
            "bench_input")

    def reader(self, metric_name):
        return load_module(self.here / "metrics" / f"{metric_name}.py",
                           "bench_metric")
