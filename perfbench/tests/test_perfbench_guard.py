"""The import guard compares whole top-level names, and neither the
benchmark's harness nor any model family's modules load JAX; a family
loads nothing of the program either."""

import os
import subprocess
import sys

import pytest

from tiny import REPO

from harness.guard import banned_modules


def test_whole_top_level_names():
    mods = ["qwen3_tts_tpu_torch", "qwen3_tts_tpu_torch.server", "jaxtyping",
            "flaxen", "numpy", "qwen3_tts_tpu", "qwen3_tts_tpu.engine",
            "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert banned_modules(mods) == sorted(
        ["qwen3_tts_tpu", "qwen3_tts_tpu.engine", "jax", "jax.numpy",
         "jaxlib.xla_client", "flax.linen"])


def test_the_program_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import qwen3_tts_tpu_torch.server, qwen3_tts_tpu_torch.engine.api; "
            "import harness.bench, harness.check; "
            "from harness.guard import banned_modules; "
            "print(banned_modules())") % (REPO + "/src", REPO + "/perfbench")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                      "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


FAMILIES = sorted(os.listdir(os.path.join(REPO, "perfbench", "families")))


@pytest.mark.parametrize("name", FAMILIES)
def test_no_family_loads_the_program_or_jax(name):
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from harness.manifest import Manifest; "
            "f = Manifest(%r).family(%r); "
            "f.reference.judge_tokens, f.weights.make_weights, f.flops.frame; "
            "print(sorted(n for n in sys.modules if n.split('.', 1)[0] in "
            "('jax', 'jaxlib', 'flax', 'qwen3_tts_tpu', 'qwen3_tts_tpu_torch')))"
            ) % (REPO + "/src", REPO + "/perfbench", REPO, name)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                      "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
