"""One run of one benchmark cell of the port ``dealii_slod_tpu_torch``.

The cell's entry in ``BENCHMARK.json`` names a configuration (its file,
``configs/<name>.json``: the solver's settings, the problem and the
coefficient law) and a traffic mix (``traffic/<name>.json``: the stream
and the loop it drives, the warm-up and the traced window); the cell's
check is in ``limits/<cell>.json`` (each number's limit, and how many
answers the check keeps).  Each name leads to a file: a stream
(``streams/<name>.py``: its input draw, its calls into the port and its
reference answers), a loop (``loops/<name>.py``: how solves are offered
and timed), a problem (``problems/<name>.py``), a coefficient law
(``laws/<name>.py``) and a metric reader (``metrics/<metric>.py``).
Nothing here names a cell, a configuration, a mix or a metric.

A run builds the solver, warms the shapes the cell uses (set-up), then
runs the mix's loop for ``--seconds`` (the cells' ``closed`` loop: one
solve in flight, each solve's input drawn on the device from (seed, solve
index) before its clock starts, its clock stopped after the prolonged
fine field is on the device and synchronised).  After the window it
reads the peak memory, frees the solver, and holds a sample of the
window's answers, drawn from the seed, to the plain reference
(``reference/slod.py``)."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "dealii_slod_tpu")
WARM = 2 ** 40


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def plugin(bench: str, folder: str, name: str):
    """The module ``<bench>/<folder>/<name>.py``: a stream, a coefficient
    law, a problem or a metric reader, found by its name."""
    path = os.path.join(bench, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"slodbench knows no {folder[:-1]} {name!r} "
                       f"(no file {os.path.relpath(path, bench)})")
    tag = "".join(c if c.isalnum() else "_" for c in f"{folder}_{name}")
    spec = importlib.util.spec_from_file_location(f"slodbench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(name: str, root: str = ROOT) -> dict:
    """Everything the cell ``name`` uses, found by the names in the
    manifest: its entry, configuration, traffic mix and the stream the
    mix names, limits and the per-layer metrics it reports."""
    man = manifest(root)
    cell = next((w for w in man["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in man["configs"] if c["name"] == cell["config"])
    bench = os.path.join(root, os.path.basename(HERE))
    traffic = load_json(os.path.join(bench, "traffic",
                                     f"{cell['traffic']}.json"))
    return dict(
        cell=cell,
        config=load_json(os.path.join(root, conf_entry["file"])),
        traffic=traffic,
        stream=plugin(bench, "streams", traffic["stream"]),
        loop=plugin(bench, "loops", traffic["loop"]),
        limits=load_json(os.path.join(bench, "limits", f"{name}.json")),
        end_to_end=[m for m in man["end_to_end"]
                    if name in m.get("workloads", [name])],
        per_layer=[m for m in man["per_layer"]
                   if name in m.get("workloads", [name])],
        bench=bench)


def metric_reader(bench: str, name: str):
    return plugin(bench, "metrics", name).read


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def refuse_banned():
    """Ends the run, with no result, where this process has loaded jax,
    jaxlib, flax or the JAX package."""
    found = banned_modules()
    if found:
        raise SystemExit(f"slodbench: modules loaded in this process: "
                         f"{found}; no result")


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

def problem_of(conf: dict, bench: str = HERE):
    return plugin(bench, "problems", conf["problem"])


def make_solver(conf: dict, device, bench: str = HERE):
    """``LODSolver`` of the configuration's settings and problem."""
    from dealii_slod_tpu_torch import LODSolver, ReductionControl, SLODConfig
    st = dict(conf["settings"])
    st["coarse_solver"] = ReductionControl(*st["coarse_solver"])
    cfg = SLODConfig(**st)
    problem = problem_of(conf, bench).port_problem(cfg)
    return LODSolver(cfg, problem, device=device, verbose=False)


def dtype_of(conf: dict) -> torch.dtype:
    return getattr(torch, conf["settings"]["dtype"])


class Inputs:
    """The inputs of a run, drawn on the device from (seed, kind, index):
    coefficient fields by the configuration's law (``laws/<law>.py``, at
    every fine cell's Gauss points) and fine load vectors (standard normal,
    zero at Dirichlet nodes)."""

    def __init__(self, conf: dict, seed: int, device, dtype,
                 bench: str = HERE):
        st, law = conf["settings"], conf["coefficients"]
        self.seed, self.device, self.dtype = seed, torch.device(device), dtype
        self.names = law["names"]
        self.C = problem_of(conf, bench).components(st)
        dim = st["dim"]
        n = 2 ** st["n_global_refinements"] * st["n_subdivisions"]
        h = 1.0 / n
        bits = np.stack(np.meshgrid(*[[0, 1]] * dim, indexing="ij")[::-1],
                        -1).reshape(-1, dim)
        gauss = np.where(bits == 1, 0.5 + 0.5 / np.sqrt(3), 0.5 - 0.5 /
                         np.sqrt(3))
        cells = np.stack(np.meshgrid(*[np.arange(n)] * dim,
                                     indexing="ij")[::-1], -1).reshape(-1, dim)
        pts = (cells[:, None, :] + gauss[None]) * h     # (cells, nq, dim)
        self.law = plugin(bench, "laws", law["law"]).Law(law, pts,
                                                         self.device, dtype)
        nodes = np.stack(np.meshgrid(*[np.arange(n + 1)] * dim,
                                     indexing="ij")[::-1], -1).reshape(-1, dim)
        self.n_nodes = len(nodes)
        self.interior = torch.as_tensor(
            ~((nodes == 0) | (nodes == n)).any(-1), device=self.device)
        self.gen = torch.Generator(device=self.device)

    def _gen(self, stream: int, i: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed % 2 ** 63, stream, i])
        self.gen.manual_seed(int(state.generate_state(1, np.uint64)[0]) >> 1)
        return self.gen

    def field(self, i: int, setup: bool = False) -> dict:
        """Coefficients {name: (n_fine_cells, nq)} of solve i (or of the
        set-up field)."""
        return {name: self.law.sample(self._gen(1000 + s if setup else 1 + s,
                                                i))
                for s, name in enumerate(self.names)}

    def load(self, i: int) -> torch.Tensor:
        """Fine load vector (n_nodes, C) of solve i."""
        g = self._gen(100, i)
        f = torch.randn((self.n_nodes, self.C), generator=g,
                        dtype=self.dtype, device=self.device)
        return torch.where(self.interior[:, None], f, 0.0)


class Reservoir:
    """A uniform sample of ``m`` of the window's answers, drawn from the
    seed as they come (reservoir sampling), kept in host memory."""

    def __init__(self, m: int, seed: int):
        self.m, self.items = m, {}
        self.rng = np.random.default_rng([seed % 2 ** 63, 7])

    def offer(self, i: int, u: torch.Tensor):
        slot = i if i < self.m else int(self.rng.integers(0, i + 1))
        if slot < self.m:
            self.items[slot] = (i, u.to("cpu"))

    def answers(self):
        return sorted(self.items.values(), key=lambda t: t[0])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the check against the plain reference
# ---------------------------------------------------------------------------

def reference_for(conf: dict, device, dtype=torch.float64, tf32=False,
                  bench: str = HERE):
    """The plain reference of the configuration, its spectral stage on
    the rule of the configuration's type (``dtype`` and ``tf32``: the
    precision it computes in)."""
    return problem_of(conf, bench).reference(conf["settings"], device, dtype,
                                             tf32)


def reference_fields(conf, inputs, stream, indices, device,
                     dtype=torch.float64, tf32=False, bench: str = HERE):
    """The reference's prolonged fields of the solves ``indices`` of the
    stream module ``stream``."""
    ref = reference_for(conf, device, dtype, tf32, bench)
    out = stream.reference(ref, conf, inputs, indices)
    del ref
    return out


def gap(u: torch.Tensor, v: torch.Tensor) -> float:
    """||u - v||_2 / ||v||_2 over every fine dof (v the reference)."""
    u = u.double().reshape(-1)
    v = v.double().reshape(-1)
    return float(torch.linalg.norm(u - v) / torch.linalg.norm(v))


def check(conf, inputs, stream, answers, limits, device, bench) -> dict:
    """field_gap: the widest relative L2 gap of the kept answers from the
    reference's fields of the same inputs."""
    idx = [i for i, _ in answers]
    refs = reference_fields(conf, inputs, stream, idx, device, bench=bench)
    g = max(gap(u, v) for (_, u), v in zip(answers, refs))
    return {"field_gap": {"value": g, "limit": limits["field_gap"]}}


# ---------------------------------------------------------------------------
# spans and the trace
# ---------------------------------------------------------------------------

class Spans:
    """Synced host spans around the calls into each layer; each also a
    ``record_function`` range, so the profiler's trace holds it."""

    def __init__(self, device):
        self.device, self.times = device, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(f"slodbench/{name}"):
            t0 = time.perf_counter()
            yield
            sync(self.device)
            self.times.setdefault(name, []).append(time.perf_counter() - t0)


@contextlib.contextmanager
def launch_records(records: list):
    """Each hand-kernel launch through ``utils/kernels.launch`` inside a
    ``record_function`` range ``slodbench/launch/<n>``, its entry, dtype
    and sizes appended to ``records``."""
    from dealii_slod_tpu_torch.utils import kernels
    orig = kernels.launch

    def launch(name, entry, dtype, device, *args):
        records.append((entry, torch.empty((), dtype=dtype).element_size(),
                        args))
        with torch.profiler.record_function(
                f"slodbench/launch/{len(records) - 1}"):
            return orig(name, entry, dtype, device, *args)

    kernels.launch = launch
    try:
        yield
    finally:
        kernels.launch = orig


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def traced_window(stream, loop, inputs, draw, seconds, device, keep, first,
                  max_solves):
    """The traced window: ``torch.profiler`` over up to ``max_solves``
    solves (or ``seconds``) of the mix's loop, each through the stream's
    traced calls."""
    import trace_reduce
    spans, counters, records = Spans(device), {}, []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def solve(x):
        with spans("solve"):
            return stream.traced(x, spans, counters)

    with torch.profiler.profile(activities=acts) as prof:
        with launch_records(records), \
                torch.profiler.record_function("slodbench/window"):
            _, _, n, bad = loop.window(solve, inputs, draw, seconds, device,
                                       keep, sync, first, max_solves)
    tmp = os.environ.get("TMPDIR") or os.path.join(ROOT, ".slodbench_cache")
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, f"slodbench_trace_{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        summary = trace_reduce.reduce(load_json(path), records)
    finally:
        if os.path.exists(path):
            os.remove(path)
    return dict(spans=spans.times, counters=counters, solves=n,
                trace=summary, records=records, bad=bad)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_process=None, root: str = ROOT, conf=None,
        stream_hook=None) -> dict:
    """One run of the cell; returns the result line's object.  ``conf``
    replaces the cell's configuration and ``stream_hook(stream)`` wraps
    the stream (tests: tiny sizes on the CPU, a broken timed path)."""
    t_process = time.perf_counter() if t_process is None else t_process
    spec = resolve(cell_name, root)
    conf = conf or spec["config"]
    traffic, limits, mix = spec["traffic"], spec["limits"], spec["stream"]
    bench, draw, loop = spec["bench"], spec["stream"].draw, spec["loop"]
    device = torch.device(device)
    dtype = dtype_of(conf)
    torch.manual_seed(0)

    # set-up: the solver, the cell's state, its shapes warmed
    parts = [("start", time.perf_counter())]
    solver = make_solver(conf, device, bench)
    inputs = Inputs(conf, seed, device, dtype, bench)
    parts.append(("solver", time.perf_counter()))
    stream = mix.Stream(solver, inputs)
    if stream_hook is not None:
        stream = stream_hook(stream)
    sync(device)
    parts.append(("state", time.perf_counter()))
    # warm-up inputs come from indices no window reaches
    for i in range(traffic["warm_solves"]):
        u = stream.solve(draw(inputs, WARM + i))
    if trace:
        u = stream.traced(draw(inputs, WARM), Spans(device), {})
    sync(device)
    del u
    parts.append(("warm-up", time.perf_counter()))
    setup_s = parts[-1][1] - t_process
    log(f"[slodbench] {cell_name} seed {seed}: set-up {setup_s:.3f} s: "
        f"process and imports {parts[0][1] - t_process:.3f}, "
        + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                    for a, b in zip(parts, parts[1:])))

    keep = Reservoir(limits["keep"], seed)
    layer = None
    if trace:
        # an untraced stretch first: the traced solves' overhead against it
        lat0, _, nxt, bad = loop.window(stream.solve, inputs, draw,
                                        traffic["untraced_seconds"], device,
                                        keep, sync)
        layer = traced_window(stream, loop, inputs, draw, seconds, device,
                              keep, nxt, traffic["trace_solves"])
        lat = layer["spans"]["solve"]
        bad = bad + layer["bad"]
        log(f"[slodbench] tracing overhead: traced solve median "
            f"{statistics.median(lat) * 1e3:.3f} ms, untraced "
            f"{statistics.median(lat0) * 1e3:.3f} ms")
        lat = lat0 + lat
    else:
        lat, window_s, _, bad = loop.window(stream.solve, inputs, draw,
                                            seconds, device, keep, sync)
    attempted = len(lat)
    failed = int(bad)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    refuse_banned()
    del stream, solver
    if device.type == "cuda":
        torch.cuda.empty_cache()

    compared = check(conf, inputs, mix, keep.answers(), limits, device,
                     bench)
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit()
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        tr = layer["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        ctx, wanted = dict(layer, conf=conf), spec["per_layer"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    else:
        ctx = dict(latencies=lat, window_s=window_s, peak_bytes=peak,
                   setup_s=setup_s, conf=conf)
        wanted = spec["end_to_end"]
    metrics = {}
    for m in wanted:
        v = metric_reader(bench, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = dev
    out["compared"] = compared
    # what the check and the metric readers loaded counts too
    refuse_banned()
    for name, c in compared.items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    return out
