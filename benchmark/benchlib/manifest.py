"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration names the command it drives. Each is a file of its
own under the benchmark's folder:

- ``configs/<config>.json`` (the file the manifest's ``configs`` entry
  gives), holding ``command`` and the sizes;
- ``traffic/<traffic>.json``;
- ``commands/<command>.py``: how that command is driven and judged;
- ``metrics/<metric>.py``: one reader a metric, end-to-end or per-layer.

Adding a cell, a configuration, a mix, a command or a metric is adding
files and manifest entries; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """A Python file loaded as a module under ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one cell of the manifest needs, loaded from its files."""

    def __init__(self, manifest: dict, name: str, *, root: str = CHECKOUT,
                 bench_dir: str = BENCH_DIR):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in the manifest; have "
                           f"{sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        entry = configs[self.workload["config"]]
        self.config = load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", f"{self.workload['traffic']}.json"))
        self.command = load_module(
            os.path.join(bench_dir, "commands",
                         f"{self.config['command']}.py"),
            f"bench_command_{self.config['command']}")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if self._applies(m)]
        self.per_layer = [m for m in manifest["per_layer"]
                          if self._applies(m)]
        self.readers = {}
        for m in self.end_to_end + self.per_layer:
            name = m["name"]
            self.readers[name] = load_module(
                os.path.join(bench_dir, "metrics", f"{name}.py"),
                "bench_metric_" + name.replace(".", "_").replace("-", "_"))

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def read(self, ctx, traced: bool) -> Dict[str, dict]:
        """Each of this run's metrics (the per-layer ones in a traced run,
        else the end-to-end ones) that its reader finds something for, as
        ``{name: {"value", "unit"}}``."""
        out = {}
        for m in self.per_layer if traced else self.end_to_end:
            value = self.readers[m["name"]].read(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def load_manifest(root: str = CHECKOUT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))
