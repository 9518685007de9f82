"""The manifest keeps to the benchmark's contract, every cell resolves
by file name, a new mix with a new stream added as files alone makes a
runnable cell, a name with no file is refused, and a run that has loaded
jax by its end prints no result."""

import json
import os
import re
import shutil
import sys

import pytest
import torch

import harness
from tiny import tiny

ROOT = harness.ROOT
MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in MAN["command"])
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        names.append(c["name"])
    assert len({c["file"] for c in MAN["configs"]}) == len(names)
    assert set(names) == {w["config"] for w in MAN["workloads"]}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in MAN["workloads"]}) == len(MAN["workloads"])
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_resolves(cell):
    spec = harness.resolve(cell)
    for part in ("Stream", "draw", "reference"):
        assert hasattr(spec["stream"], part)
    assert callable(spec["loop"].window)
    conf = spec["config"]
    assert callable(harness.problem_of(conf).port_problem)
    assert os.path.isfile(os.path.join(harness.HERE, "laws",
                                       conf["coefficients"]["law"] + ".py"))
    assert set(spec["limits"]) == {"field_gap", "keep"}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"] + spec["end_to_end"]:
        assert callable(harness.metric_reader(spec["bench"], m["name"]))
        # what a metric moves, the cell reports
        assert m.get("moves", "setup_s") in e2e


# a stream no file of the benchmark has: a new coefficient field and a
# new load vector every solve, through the step
FIELD_AND_LOAD = '''"""A new field and a new load vector every solve."""


def draw(inputs, i):
    return inputs.field(i), inputs.load(i)


class Stream:
    def __init__(self, solver, inputs):
        self.s = solver
        solver.assemble_fine_rhs()
        self.step = solver.build_step()

    def solve(self, x):
        self.step(*x)
        return self.s.prolong_lod_solution()

    def traced(self, x, span, counters):
        with span("step"):
            return self.solve(x)


def reference(ref, conf, inputs, indices):
    out = []
    for i in indices:
        ref.build(inputs.field(i))
        out.append(ref.solve(inputs.load(i)).double().cpu())
    return out
'''


def copy_with_cell(tmp_path, cell: dict, files: dict):
    """The benchmark copied to ``tmp_path`` with ``files`` added (paths
    under ``slodbench/``) and ``cell`` appended to the manifest's cells;
    returns the copy's root and the bytes of every file it had before."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "slodbench"), root / "slodbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "slodbench").rglob("*")
              if p.is_file()}
    man = json.loads(json.dumps(MAN))
    man["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for rel, text in files.items():
        (root / "slodbench" / rel).write_text(text)
    return root, before


def test_new_mix_is_files_only(tmp_path):
    """A new stream, a mix that names it, a limits file and a cell entry,
    in a copy: the cell resolves and runs, and its answers are held to
    the reference, with no edit to any file already there."""
    cell = "diffusion-3d-4096.field_loads"
    root, before = copy_with_cell(
        tmp_path, dict(name=cell, config="diffusion-3d-4096",
                       traffic="field_loads", chips=1,
                       why="a new field and a new load every solve"),
        {"streams/field_load.py": FIELD_AND_LOAD,
         "traffic/field_loads.json": json.dumps(
             {"stream": "field_load", "loop": "closed", "warm_solves": 1,
              "untraced_seconds": 0.2, "trace_solves": 2}),
         f"limits/{cell}.json": json.dumps({"field_gap": 1e-6, "keep": 2})})
    spec = harness.resolve(cell, root=str(root))
    assert spec["stream"].__file__.startswith(str(root))
    conf = tiny(spec["config"], dtype="float64")
    # the configuration's coarse CG stops at a 1e-6 relative residual,
    # which alone moves the field ~1e-6 from the reference's exact solve
    conf["settings"]["coarse_solver"] = [4000, 1e-15, 1e-15]
    out = harness.run(cell, 5, 0.3, False, device="cpu", root=str(root),
                      conf=conf)
    assert out["correct"] and out["attempted"] >= 1, out["compared"]
    # every end-to-end metric but the card's memory, which a CPU run lacks
    assert set(out["metrics"]) == {m["name"] for m in MAN["end_to_end"]
                                   if m["name"] != "peak_gib"}
    # the loads differ from the configuration's rhs: a field stream's
    # answers are not this stream's
    field = harness.plugin(harness.HERE, "streams", "field")
    inputs = harness.Inputs(conf, 5, "cpu", torch.float64)
    ref = harness.reference_for(conf, "cpu")
    a, b = (s.reference(ref, conf, inputs, [0])[0]
            for s in (spec["stream"], field))
    assert harness.gap(a, b) > 0.1
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("part,key", [("law", ("coefficients", "law")),
                                      ("problem", ("problem",))])
def test_unknown_name_is_refused(part, key):
    """A configuration that names a law or a problem with no file of its
    own is refused, never run by another one."""
    conf = tiny(harness.resolve("diffusion-3d-4096.samples")["config"])
    d = conf
    for k in key[:-1]:
        d = d[k]
    d[key[-1]] = "lognormal_correlated"
    with pytest.raises(KeyError, match="knows no"):
        harness.run("diffusion-3d-4096.samples", 1, 0.1, False,
                    device="cpu", conf=conf)


SNEAKY = '''import sys
import types


def read(ctx):
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return 1.0
'''


def test_jax_loaded_after_the_window_ends_the_run(tmp_path):
    """A metric reader that loads ``jax`` (after the window has closed):
    the run ends with no result, naming what it found."""
    cell = "diffusion-3d-4096.sneaky"
    man = json.loads(json.dumps(MAN))
    root, _ = copy_with_cell(
        tmp_path, dict(name=cell, config="diffusion-3d-4096",
                       traffic="loads", chips=1, why="loads jax late"),
        {"metrics/sneaky.py": SNEAKY,
         f"limits/{cell}.json": json.dumps({"field_gap": 1e-6, "keep": 1})})
    man["workloads"].append(dict(name=cell, config="diffusion-3d-4096",
                                 traffic="loads", chips=1,
                                 why="loads jax late"))
    man["end_to_end"].append(dict(name="sneaky", unit="s", better="lower",
                                  bound=0.25, source="host_clock",
                                  workloads=[cell]))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    conf = tiny(harness.resolve(cell, root=str(root))["config"],
                dtype="float64")
    assert "jax" not in sys.modules
    try:
        with pytest.raises(SystemExit, match="jax"):
            harness.run(cell, 3, 0.1, False, device="cpu", root=str(root),
                        conf=conf)
    finally:
        sys.modules.pop("jax", None)
