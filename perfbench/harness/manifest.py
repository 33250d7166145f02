"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Its files: the configuration's ``file``, ``perfbench/traffic/<traffic>.json``
(the mix), ``perfbench/workloads/<cell>.json`` (the cell's check: how many
requests it judges and each compared number's limit) and one reader module
``perfbench/metrics/<metric>.py`` per metric it reports.

A configuration's file names its model family under ``"family"``
(``port_geometry`` where it names none). A family is the code of one model
layout, in ``perfbench/families/<family>/``: ``weights.py``
(``make_weights``), ``reference.py`` (``judge_tokens``, ``code2wav``,
``startup_samples``) and ``flops.py`` (``frame``, ``prompt``,
``prompt_rows``, ``seed_frame``). Adding a cell, a configuration, a metric
or a model layout (a family) adds files and entries; no file changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from types import ModuleType

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DEFAULT_FAMILY = "port_geometry"
FAMILY_MODULES = ("weights", "reference", "flops")


def root_of(path: str) -> str:
    """The checkout's root: the directory above ``perfbench``."""
    return os.path.dirname(os.path.dirname(os.path.abspath(path)))


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _load(path: str, name: str) -> ModuleType:
    """The module at ``path``, loaded under ``name`` (not in sys.modules)."""
    spec = importlib.util.spec_from_file_location(
        re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_of(cfg: dict) -> str:
    """The model family a configuration names."""
    return cfg.get("family", DEFAULT_FAMILY)


@dataclass(frozen=True)
class Family:
    """One model layout's modules (``perfbench/families/<name>/``)."""

    name: str
    weights: ModuleType
    reference: ModuleType
    flops: ModuleType


class Manifest:
    def __init__(self, root: str):
        self.root = root
        self.bench = _json(os.path.join(root, "BENCHMARK.json"))
        self.perfbench = os.path.join(root, "perfbench")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.perfbench, "traffic", f"{name}.json"))

    def cell_file(self, name: str) -> dict:
        return _json(os.path.join(self.perfbench, "workloads", f"{name}.json"))

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` False) or its per-layer
        metrics (``trace`` True): those that list it, or that list no cells
        (end to end: every cell; per layer: every cell reporting the
        metric it moves)."""
        e2e = [m for m in self.bench["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return e2e
        moves = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in moves)]

    def reader(self, metric: str):
        """The ``read(ctx)`` function of ``perfbench/metrics/<metric>.py``."""
        path = os.path.join(self.perfbench, "metrics", f"{metric}.py")
        return _load(path, "perfbench_metric_" + metric).read

    def family(self, name: str) -> Family:
        """The modules of the model family ``name``."""
        d = os.path.join(self.perfbench, "families", name)
        return Family(name, *(_load(os.path.join(d, f"{m}.py"),
                                    f"perfbench_family_{name}_{m}")
                              for m in FAMILY_MODULES))


def problems(bench: dict, root: str) -> list[str]:
    """What in ``bench`` breaks the manifest's rules: names and units, each
    configuration used and its file present, each configuration's family
    present with its three modules, each cell's files present, each
    metric's reader present, and each ``moves`` reported in every cell of
    its metric."""
    out = []
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["config"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    metrics = bench["end_to_end"] + bench["per_layer"]
    out += [f"bad unit {m['unit']!r}" for m in metrics if not UNIT.match(m["unit"])]
    for kind in ("configs", "workloads"):
        seen = [x["name"] for x in bench[kind]]
        out += [f"duplicate {kind} name {n}" for n in set(seen)
                if seen.count(n) > 1]
    seen = [m["name"] for m in metrics]
    out += [f"duplicate metric {n}" for n in set(seen) if seen.count(n) > 1]
    cells = {w["name"]: w for w in bench["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    pb = os.path.join(root, "perfbench")
    for c in bench["configs"]:
        if c["name"] not in used:
            out.append(f"config {c['name']} has no cell")
        path = os.path.join(root, c["file"])
        if not os.path.isfile(path):
            out.append(f"config file {c['file']} missing")
            continue
        fam = family_of(_json(path))
        if not NAME.match(fam):
            out.append(f"config {c['name']}: bad family name {fam!r}")
            continue
        d = os.path.join(pb, "families", fam)
        if not os.path.isdir(d):
            out.append(f"config {c['name']} names unknown family {fam}")
            continue
        out += [f"family {fam} lacks {m}.py" for m in FAMILY_MODULES
                if not os.path.isfile(os.path.join(d, f"{m}.py"))]
    for w in bench["workloads"]:
        if w["config"] not in {c["name"] for c in bench["configs"]}:
            out.append(f"cell {w['name']} names unknown config {w['config']}")
        for path in (os.path.join(pb, "traffic", f"{w['traffic']}.json"),
                     os.path.join(pb, "workloads", f"{w['name']}.json")):
            if not os.path.isfile(path):
                out.append(f"cell {w['name']}: {path} missing")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in metrics:
        if not os.path.isfile(os.path.join(pb, "metrics", f"{m['name']}.py")):
            out.append(f"metric {m['name']} has no reader")
        for cell in m.get("workloads", ()):
            if cell not in cells:
                out.append(f"metric {m['name']} lists unknown cell {cell}")
    for m in bench["per_layer"]:
        target = e2e.get(m["moves"])
        if target is None:
            out.append(f"{m['name']} moves unknown metric {m['moves']}")
            continue
        for cell in m.get("workloads", list(cells)):
            if "workloads" in target and cell not in target["workloads"]:
                out.append(f"{m['name']}: cell {cell} does not report "
                           f"{m['moves']}")
    for w in bench["workloads"]:
        has_e2e = [m for m in bench["end_to_end"]
                   if "workloads" not in m or w["name"] in m["workloads"]]
        if "setup_s" not in [m["name"] for m in has_e2e] or len(has_e2e) < 2:
            out.append(f"cell {w['name']} lacks setup_s or another "
                       "end-to-end metric")
    return out
