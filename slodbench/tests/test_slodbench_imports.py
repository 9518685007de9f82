"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
(by whole top-level name: the port's name begins with the JAX
package's), and the plain reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

import harness

BENCH = harness.HERE
ROOT = harness.ROOT


def top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not \
                node.level:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_sources_import_no_jax():
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not set(top_imports(path)) & set(harness.BANNED), path


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        assert "dealii_slod_tpu_torch" not in set(top_imports(path)), path
    code = ("import sys; sys.path.insert(0, %r); import reference.slod; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    loaded = set(eval(out))
    assert not loaded & {"dealii_slod_tpu_torch", *harness.BANNED}


def test_a_run_loads_no_jax():
    """A whole run, at a small size on the CPU, in a fresh process."""
    code = f"""
import sys
sys.path[:0] = [{ROOT!r}, {BENCH!r}, {os.path.join(BENCH, 'tests')!r}]
import harness
from tiny import tiny
spec = harness.resolve("diffusion-3d-4096.samples")
out = harness.run("diffusion-3d-4096.samples", 1, 0.2, True, device="cpu",
                  conf=tiny(spec["config"]))
assert out["correct"], out
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "dealii_slod_tpu_torch" in loaded
    assert not loaded & set(harness.BANNED)


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing on
    standard output (this sandbox has none; on the card, skip)."""
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "diffusion-3d-4096.samples", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
