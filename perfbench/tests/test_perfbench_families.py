"""Model families found by name: the port's geometry reproduces what the
benchmark drew, judged and counted before families existed, and a family
added as files is found, drawn from, judged by and counted by."""

import hashlib
import json
import os
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from tiny import REPO, SEED, TINY, TINY_DENSE, family, make_root

from harness.bench import run_cell
from harness.manifest import Manifest, problems
from reference import model as ref
from reference.prompt import text_tokens
from reference.quant import CONTROL, REFERENCE

PORT = family("port_geometry")

# SHA-256 of every leaf drawn, and of the logits and waveform of REQUEST,
# recorded from the benchmark's code before it was split into families
# (CPU, one thread, at SEED)
RECORDED = {
    "tiny": {
        "weights": "e7031058618816959a3358763b01409eeb5365e078d08b295723fd181aa36ef5",
        "reference": ("bafd613219ba5c740239b927ab0e2f0eed8dbcf89f33849896176fc95fe3d33a",
                      "a4d8d41a71bd3404c8f5ac1e81b54d834a89b78342fd9ef721b0cb092445d3fa",
                      "ec456a5eae1356264a9dafeff3b4da23fc1842d7e899657da43c437b95f9669b"),
        "lower": ("956c535a1dc4bb6b185fcacdfec3104beef76169158c1bd17523743a8ae7497a",
                  "aecf51c5a2b25cb8b02a09a487b3dfdbee9fa0f553d3e92af31df50d1f84fcb5",
                  "e6081385fe412619f64df2256e197a11e32baeb0de558fd68ab0354a85dd1da0"),
    },
    "tiny_dense": {
        "weights": "a94f9200e31750965478a56b1de195ae233f6252524d74196fc21fc9c2a3ac1e",
        "reference": ("3fc1f7bbf484c4d4d685aff89b6ce326c74f98bdf1b70bf87af83a175eb10d42",
                      "d442841fc05bd733301782211ed687daef780075999c8bcc5ef656a8fd736591",
                      "2e7fd70deb73e0c11397822ecf500394e1a887ce2c3734554c70570719c5a234"),
        "lower": ("887b205abc7482f6e918017945368c6e3d4ad9dea2fe40757ed3398af58df558",
                  "1558c0dcebd334309fcee7a1b12a81d28f087e237bd2592a1799bd5b8f8ff714",
                  "af055abe31142ce79b00da28bd94a358257f87b1243980317f084f60346a30de"),
    },
}
# FLOPs of frames (position 9 + i, index i), the 9-row prompt and the
# seed frame, at both cells' configurations (the same geometry)
FRAMES = {0: 10300367872, 1: 10300630016, 71: 10318980096, 72: 10319209472,
          959: 10522665984}
PROMPT, SEED_FRAME = 25385873408, 3617718272
CELL_CONFIGS = ["qwen3-tts-1.7b-port-geometry-int8",
                "qwen3-tts-1.7b-port-geometry-bf16"]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def digest(tree) -> str:
    """SHA-256 over every leaf's path, type, shape and bytes, in order."""
    h = hashlib.sha256()
    for path, t in _leaves(tree):
        t = t.detach().contiguous().cpu()
        h.update(f"{path}:{t.dtype}:{tuple(t.shape)};".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _request(cfg):
    g = torch.Generator().manual_seed(7)
    w = cfg["code2wav"]
    codes = torch.randint(0, w["codebook_size"], (13, w["num_quantizers"]),
                          generator=g)
    return {"tokens": text_tokens("A quiet river runs past the village.",
                                  "Whispering quietly"),
            "speaker_id": cfg["speakers"].index("sohee"), "codes": codes}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name,cfg", [("tiny", TINY), ("tiny_dense", TINY_DENSE)])
def test_port_geometry_draws_and_judges_as_before(one_thread, name, cfg):
    raw = PORT.weights.make_weights(cfg, SEED, "cpu")
    assert digest(raw) == RECORDED[name]["weights"]
    req = _request(cfg)
    with torch.inference_mode(), ref.no_tf32():
        for prec in (REFERENCE, CONTROL):
            W = ref.Weights(raw, prec)
            lg0, lgd = PORT.reference.judge_tokens(W, cfg, req)
            wav = PORT.reference.code2wav(W, cfg["code2wav"],
                                          req["codes"][1:].T)
            got = (digest(lg0), digest(lgd), digest(wav))
            assert got == RECORDED[name][prec.name], prec.name


@pytest.mark.parametrize("config", CELL_CONFIGS)
def test_port_geometry_counts_as_before(config):
    with open(os.path.join(REPO, "perfbench", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    fl = PORT.flops
    L = fl.prompt_rows(cfg)
    assert L == 9
    assert {i: fl.frame(cfg, L + i, i) for i in FRAMES} == FRAMES
    assert fl.prompt(cfg, L) == PROMPT
    assert fl.seed_frame(cfg) == SEED_FRAME


MARK = '''

import os as _os


def _marked(f, what):
    def g(*a, **k):
        open(_os.path.join(_os.path.dirname(__file__), "seen." + what), "w").close()
        return f(*a, **k)
    return g


{name} = _marked({name}, "{module}")
'''


def _add_family(root: str, name: str, drop: str | None = None) -> str:
    """A copy of port_geometry as family ``name`` in ``root``, each module
    marking a file ``seen.<module>`` when used; ``drop`` one module left
    out."""
    fams = os.path.join(root, "perfbench", "families")
    d = os.path.join(fams, name)
    shutil.copytree(os.path.join(fams, "port_geometry"), d,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for module, fn in (("weights", "make_weights"),
                       ("reference", "judge_tokens"), ("flops", "frame")):
        with open(os.path.join(d, f"{module}.py"), "a") as f:
            f.write(MARK.format(name=fn, module=module))
    if drop:
        os.remove(os.path.join(d, f"{drop}.py"))
    return d


def _add_cell(root: str, config: dict, cell: str) -> dict:
    """A configuration file and a cell on it, with their entries."""
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "configs", f"{config['name']}.json"), "w") as f:
        json.dump(config, f)
    shutil.copy(os.path.join(pb, "workloads", "tiny.json"),
                os.path.join(pb, "workloads", f"{cell}.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": config["name"], "source": TINY["source"],
                             "file": f"perfbench/configs/{config['name']}.json",
                             "reduced": [], "why": "a later model layout"})
    bench["workloads"].append({"name": cell, "config": config["name"],
                               "traffic": "tiny4", "chips": 1,
                               "why": "a later cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


def _files(root: str) -> dict:
    out = {}
    for dirpath, dirs, files in os.walk(os.path.join(root, "perfbench")):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                out[os.path.join(dirpath, name)] = f.read()
    return out


def test_a_family_added_as_files_is_found(tmp_path):
    root = make_root(str(tmp_path))
    before = _files(root)
    d = _add_family(root, "marked")
    bench = _add_cell(root, {**TINY, "name": "tiny-marked", "family": "marked"},
                      "tiny-marked")
    after = _files(root)
    assert all(after[p] == b for p, b in before.items())   # only added
    assert problems(bench, root) == []
    man = Manifest(root)
    assert man.family("marked").weights.__file__ == os.path.join(d, "weights.py")

    result, lines = run_cell(root, "tiny-marked", SEED, 2.0, False,
                             time.perf_counter(), device="cpu")
    assert result["correct"], lines
    assert os.path.exists(os.path.join(d, "seen.weights"))
    assert os.path.exists(os.path.join(d, "seen.reference"))
    # the cell's FLOP count is its family's: one delivery of 4 frames
    hop = 12
    ctx = SimpleNamespace(
        config=TINY, family=man.family("marked"), hop=hop, t_open=0.0,
        t_close=10.0, records=[],
        recorder=SimpleNamespace(collects=[(1.0, 4, [(None, 0, 0)]),
                                           (3.0, 4, [(None, 1, 4 * hop)])]))
    mfu = man.reader("model.mfu")(ctx)
    assert os.path.exists(os.path.join(d, "seen.flops"))
    fl = PORT.flops
    want = sum(fl.frame(TINY, 9 + f, f) for f in range(4))
    assert mfu == pytest.approx(100.0 * want / 2.0 / 989e12)


@pytest.mark.parametrize("family_name,drop,why", [
    ("absent", None, "names unknown family absent"),
    ("partial", "flops", "family partial lacks flops.py"),
    ("bad name", None, "bad family name 'bad name'"),
])
def test_an_unknown_or_incomplete_family_is_refused(tmp_path, family_name,
                                                    drop, why):
    root = make_root(str(tmp_path))
    if family_name == "partial":
        _add_family(root, family_name, drop=drop)
    bench = _add_cell(root, {**TINY, "name": "tiny-other",
                             "family": family_name}, "tiny-other")
    assert any(why in p for p in problems(bench, root)), problems(bench, root)
    with pytest.raises(ValueError, match="BENCHMARK.json"):
        run_cell(root, "tiny-other", SEED, 2.0, False, time.perf_counter(),
                 device="cpu")
