"""The benchmark's manifest, ``BENCHMARK.json``, and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell
or one metric sits in a file of its own, found here by its name:

- a configuration: the ``file`` its entry names (sizes, source,
  ``reduced``, ``assumed``), whose ``architecture`` names the plain
  reference ``reference/<architecture>.py``;
- a traffic mix: ``traffic/<mix>.json``, whose ``kind`` names the runner
  ``harness/<kind>.py``;
- a cell's limits for ``correct``: ``limits/<cell>.json``;
- a metric, end-to-end or per-layer: the reader ``metrics/<metric>.py``.

A search path of benchmark folders (the tests put their own tiny cell's
folder first) is looked through in order.
"""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, spec: dict, repo_root: Path = REPO_ROOT,
                 search=(BENCH_DIR,)):
        self.spec = spec
        self.repo_root = Path(repo_root)
        self.search = [Path(p) for p in search]
        self.configs = {c["name"]: c for c in spec["configs"]}
        self.cells = {w["name"]: w for w in spec["workloads"]}

    @classmethod
    def load(cls, path: Path = REPO_ROOT / "BENCHMARK.json", **kw):
        with open(path) as f:
            return cls(json.load(f), repo_root=Path(path).parent, **kw)

    def _find(self, sub: str, name: str, ext: str) -> Path:
        for d in self.search:
            p = d / sub / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {sub}/{name}{ext} under "
                                f"{[str(d) for d in self.search]}")

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"unknown workload {name!r}; the manifest has "
                           f"{sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        entry = self.configs[name]
        with open(self.repo_root / entry["file"]) as f:
            return json.load(f)

    def mix(self, name: str) -> dict:
        with open(self._find("traffic", name, ".json")) as f:
            return json.load(f)

    def limits(self, cell: str) -> dict:
        """The cell's limits, or {} where none has been set yet (every
        compared number then reads as over its limit)."""
        try:
            path = self._find("limits", cell, ".json")
        except FileNotFoundError:
            return {}
        with open(path) as f:
            return json.load(f)

    def metrics_for(self, cell: str, group: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports:
        those that list it under ``workloads``, and those without that
        key whose end-to-end metric (or, for an end-to-end one, itself)
        the cell reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if group == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def reader(self, metric: str):
        """The ``read(run)`` function of ``metrics/<metric>.py``."""
        return _load(self._find("metrics", metric, ".py"), metric).read

    def runner(self, kind: str):
        """``harness/<kind>.py``, imported as ``harness.<kind>``, so a
        tool that patches the runner patches the one the run uses."""
        self._find("harness", kind, ".py")
        return importlib.import_module(f"harness.{kind}")

    def reference(self, architecture: str):
        return _load(self._find("reference", architecture, ".py"),
                     f"reference_{architecture}")


_LOADED = {}


def _load(path: Path, name: str):
    """Import a file by path once (metric names hold dots, so they are
    no module names)."""
    key = str(path)
    if key not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            "bench_" + name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]
