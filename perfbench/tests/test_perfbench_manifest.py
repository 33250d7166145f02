"""BENCHMARK.json against the contract's rules, and the data-driven layout:
a cell, a configuration and a metric added as files and entries only."""

import json
import os
import re
import shutil
from types import SimpleNamespace

import pytest

from tiny import REPO

from harness.manifest import NAME, UNIT, Manifest, problems


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keeps_the_rules():
    assert problems(_bench(), REPO) == []


def test_manifest_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for kind, keys in allowed.items():
        for entry in b[kind]:
            assert set(entry) <= keys, (kind, entry)
    for text in ([c["why"] for c in b["configs"] + b["workloads"]]
                 + [m["layer"] for m in b["per_layer"]]
                 + [c["source"] for c in b["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(w["chips"] == 1 for w in b["workloads"])
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_every_configuration_has_a_cell_and_a_file():
    b = _bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["name"] in used
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and c["reduced"] == []


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "", "x" * 65, "é"])
def test_names_refuse_what_the_contract_refuses(bad):
    assert not NAME.match(bad)


def test_a_metric_that_moves_what_a_cell_lacks_is_refused(tmp_path):
    b = _bench()
    b["end_to_end"].append({"name": "rare_s", "unit": "s", "better": "lower",
                            "bound": 0.1, "source": "host_clock",
                            "workloads": ["bf16-batch64"]})
    b["per_layer"].append({"name": "x.y", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "engine",
                           "moves": "rare_s", "workloads": ["int8-batch64"]})
    assert any("does not report rare_s" in p for p in problems(b, REPO))


def test_a_cell_config_and_metric_added_as_files_are_found(tmp_path):
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(REPO, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = _bench()
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "configs",
                           "qwen3-tts-1.7b-port-geometry-int8.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "new-model"
    with open(os.path.join(pb, "configs", "new-model.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "batch64.json")) as f:
        mix = json.load(f)
    mix["frames"] = [100, 200]
    with open(os.path.join(pb, "traffic", "mid64.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "workloads", "new-mid64.json"), "w") as f:
        json.dump({"check": {"requests": 4, "limits": {}}}, f)
    with open(os.path.join(pb, "metrics", "engine.steps.py"), "w") as f:
        f.write('"""Steps dispatched in the window."""\n\n\n'
                "def read(ctx):\n"
                "    return sum(1 for t, *_ in ctx.recorder.dispatches\n"
                "               if ctx.t_open <= t <= ctx.t_close)\n")
    b["configs"].append({"name": "new-model", "source": "https://example.org/m",
                         "file": "perfbench/configs/new-model.json",
                         "reduced": [], "why": "a later model"})
    b["workloads"].append({"name": "new-mid64", "config": "new-model",
                           "traffic": "mid64", "chips": 1, "why": "a later cell"})
    b["per_layer"].append({"name": "engine.steps", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine", "moves": "audio_s_per_s",
                           "workloads": ["new-mid64"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    assert problems(b, root) == []
    man = Manifest(root)
    assert man.config(man.cell("new-mid64")["config"])["name"] == "new-model"
    assert man.traffic("mid64")["frames"] == [100, 200]
    assert [m["name"] for m in man.metrics("new-mid64", trace=True)] == \
        ["engine.steps"]
    assert "engine.steps" not in [m["name"] for m in
                                  man.metrics("int8-batch64", trace=True)]
    ctx = SimpleNamespace(t_open=0.0, t_close=10.0, recorder=SimpleNamespace(
        dispatches=[(1.0, 4, 64, False), (5.0, 4, 64, False),
                    (11.0, 4, 64, False)]))
    assert man.reader("engine.steps")(ctx) == 2


def test_every_listed_metric_has_a_reader():
    man = Manifest(REPO)
    for w in _bench()["workloads"]:
        for trace in (False, True):
            for m in man.metrics(w["name"], trace):
                assert callable(man.reader(m["name"]))


def test_file_names_come_from_names():
    for dirpath, _, files in os.walk(os.path.join(REPO, "perfbench")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.-]*$", f), f
