"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file is the entry's ``file``, and its
``reference`` key names the plain reference's module; the mix's file is
``traffic/<mix>.json``, and its ``entry`` key names the module that
drives the program, ``entries/<entry>.py``; a per-layer metric's reader
is ``layer_metrics/<metric>.py``, a module with ``read(view) -> float |
None``.  Adding a cell, a configuration, a mix, an entry, a reference or
a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: what a module name from a data file may be
_MODULE_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload with everything it names, read from the files."""
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple       # the manifest's entries this cell reports
    per_layer: tuple
    root: Path = ROOT       # the checkout whose files these are


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _named(kind: str, name: str, root: Path) -> Path:
    if not _MODULE_NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a name")
    return Path(root) / "perfbench" / kind


def traffic_file(mix: str, root: Path = ROOT) -> Path:
    return _named("traffic", mix, root) / f"{mix}.json"


def reader_file(metric: str, root: Path = ROOT) -> Path:
    return _named("layer_metrics", metric, root) / f"{metric}.py"


def entry_file(entry: str, root: Path = ROOT) -> Path:
    return _named("entries", entry, root) / f"{entry}.py"


def cell(name: str, root: Path = ROOT, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s manifest; KeyError if it has
    none."""
    m = load(root) if manifest is None else manifest
    w = next((w for w in m["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in m["configs"] if c["name"] == w["config"])
    config = json.loads((Path(root) / c["file"]).read_text())
    traffic = json.loads(traffic_file(w["traffic"], root).read_text())
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=tuple(e for e in m["end_to_end"]
                                 if _reports(e, name)),
                per_layer=tuple(p for p in m["per_layer"]
                                if _reports(p, name)),
                root=Path(root))


def _module(path: Path, name: str):
    """The module of the file ``path``, loaded anew under ``name`` (in
    ``sys.modules`` from then on, as an import would leave it)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of a per-layer metric's reader."""
    return _module(reader_file(metric, root),
                   f"perfbench.layer_metrics.{metric}").read


def entry(name: str, root: Path = ROOT):
    """The entry module that a traffic mix names (``entries/<name>.py``)."""
    return _module(entry_file(name, root), f"perfbench.entries.{name}")


def reference(config: dict, root: Path = ROOT):
    """The plain reference's module that a configuration names (its
    ``reference`` key, a file under ``perfbench/``).  Refuses one whose
    ``NUMERICS`` lacks the configuration's ``numeric``: a reference
    answers for the arithmetic it reproduces and for no other."""
    rel = config["reference"]
    path = (Path(root) / rel).resolve()
    if (not rel.startswith("perfbench/") or ".." in Path(rel).parts
            or path.suffix != ".py"):
        raise ValueError(f"reference {rel!r} is no module under perfbench/")
    module = _module(path, "perfbench.reference." + path.stem)
    if config["numeric"] not in getattr(module, "NUMERICS", ()):
        raise ValueError(
            f"{rel} reproduces {getattr(module, 'NUMERICS', ())}, not the "
            f"configuration's numeric {config['numeric']!r}")
    return module
