"""Nothing the benchmark loads is JAX or the JAX package, by whole
top-level names (the program's package name begins with the JAX one's)."""

import ast
import os
import subprocess
import sys

from harness import guard

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_whole_top_level_names():
    assert guard.forbidden_modules(["tailored_avsr_tpu_torch", "tailored_avsr_tpu_torch.ops", "jaxtyping",
                                    "flaxen", "numpy"]) == []
    assert guard.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "tailored_avsr_tpu",
                                    "tailored_avsr_tpu.ops"]) == ["flax.linen", "jax", "jax.numpy",
                                                                  "jaxlib.xla_client", "tailored_avsr_tpu",
                                                                  "tailored_avsr_tpu.ops"]


def test_the_harness_the_reference_and_the_program_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import main, drivers, check, trace, flops, traffic, weights, manifest\n"
            "from harness.families import tailored_avsr, branchformer_asr\n"
            "from harness.checks import greedy, nbest\n"
            "from harness.entries import greedy as g, nbest as n\n"
            "from reference import model, ctc, ops, tailored_avsr as t, branchformer_asr as b\n"
            "import tailored_avsr_tpu_torch.inference\n"
            "from harness import guard; print(guard.forbidden_modules())") % (BENCH, os.path.dirname(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(BENCH, "reference")):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(BENCH, "reference", name), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in {"torch", "numpy", "math", "contextlib", "typing", "__future__"}, (name, mod)
