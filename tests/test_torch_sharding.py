"""The scaling axes over ``torch.distributed`` (``parallel/mesh.py``)
against the JAX package, float64 on gloo CPU ranks.

The JAX side is the single-device ``build_step()`` (the reference's
sharded step is checked against it by ``__graft_entry__.py``'s dry run),
forced onto the port's routes (fused / fused_split patch solve, smallk,
the trace kernel) and computed in this process; the port's side runs
sharded in spawned ranks (``tests/torch_shard_cases.py``): one group per
rank count (2, 4, and 3 for an uneven patch count), started in two
threads at the module's setup so that the ranks run while JAX compiles,
each group's results in one file.  The port's single-device step (run by
the 3-rank group) is the second yardstick: the sharded step differs from
it only in the stencil build's batch and the CG's sum order.

Bounds (float64): A_st 1e-10 relative and u 1e-8 with the coarse CG run
to 1e-13, against JAX and against the single-device port; the direct
coarse solve likewise.  2D refine-4 l=2 is rounding-sensitive (the Grams'
eigenvalue clusters at the jitter floor; ``tests/test_torch_slice.py``):
there the bound against JAX is 10x the single-device step's own change
under a 1e-15 relative coefficient change, measured on the port (JAX's
own would cost a second 4 s JAX step), and never below those.
Measured on this CPU: sharded vs single-device port A_st 0 (bit for
bit), u <= 7.2e-13 (the CG's sums); vs JAX A_st <= 4.4e-12 and u <=
8.4e-12, but at 2D refine-4 l=2 A_st 1.2e-7 and u 5.7e-8 (the port's own
change there 2.5e-7, so the bound is 2.5e-6); MC_SHARD's QoIs 2.9e-8
from the JAX script's (bound: 10x its own change, 4.7e-7)."""

import concurrent.futures
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_cases as cases
from dealii_slod_tpu.config import ReductionControl as JaxRC
from dealii_slod_tpu.config import SLODConfig as JaxConfig
from dealii_slod_tpu.models import DiffusionProblem as JaxDiffusion
from dealii_slod_tpu.models import ElasticityProblem as JaxElasticity
from dealii_slod_tpu.models import LODSolver as JaxLOD
from dealii_slod_tpu_torch.models import stencil

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_CASES = list(cases.STEPS)
ROUTE_CASES = list(cases.ROUTES)
GROUPS = {2: STEP_CASES + ROUTE_CASES + ["cg", "sweep", "mc"],
          4: STEP_CASES + ROUTE_CASES + ["cg", "sweep"],
          3: ["uneven", "refusals", "single", "helpers"]}
A_BOUND, U_BOUND = 1e-10, 1e-8


def rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module", autouse=True)
def groups(tmp_path_factory):
    """The spawned groups, the 2- and the 3-rank one together, then the
    4-rank one: rank count -> future of their results' file.  A test asks
    JAX for its reference before it waits for a group."""
    tmp = tmp_path_factory.mktemp("shard")
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futs = {n: pool.submit(cases.run, str(tmp / f"ranks{n}.pt"), n,
                           GROUPS[n]) for n in (2, 3, 4)}
    futs["failing"] = pool.submit(cases.run_failing)
    yield futs
    pool.shutdown(wait=True)


@functools.lru_cache(maxsize=None)
def _load(path):
    return torch.load(path, weights_only=False)


def group(groups, n):
    return _load(groups[n].result(timeout=600))


@functools.lru_cache(maxsize=None)
def jax_solver(name):
    """The JAX package's solver of a case and its jitted step."""
    kw, elastic = cases.STEPS[name]
    kw = dict(cases.BASE, **kw)
    cfg = JaxConfig(**dict(kw, coarse_solver=JaxRC(*kw["coarse_solver"])))
    js = JaxLOD(cfg, (JaxElasticity if elastic else JaxDiffusion)(cfg),
                verbose=False)
    js.assemble_fine_rhs()
    return js, jax.jit(js.build_step())


@functools.lru_cache(maxsize=None)
def jax_ref(name):
    """JAX's single-device (u, A_st) of a case."""
    js, step = jax_solver(name)
    return tuple(np.asarray(v) for v in step(js.coef_q, js.fem_rhs))


@pytest.mark.parametrize("name", STEP_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_matches_jax(groups, n, name):
    """``build_step(make_mesh(n))`` on n ranks: DTensors sharded over the
    patch axis, P / n rows a rank; ``full_tensor()`` of u and A_st against
    JAX's single-device step and the port's; every rank's CG ran as many
    iterations."""
    ju, jA = jax_ref(name)
    out = group(groups, n)[name]
    single = group(groups, 3)["single"]
    u1, A1 = single[name]
    sens = 10 * single["sens"] if name == "2d-r4-l2" else 0.0
    P = len(ju)
    assert out["placements"] == ["Shard"] * 2
    assert out["local_rows"] == [P // n] * n
    assert out["u"].shape == ju.shape and out["A_st"].shape == jA.shape
    assert rel(out["A_st"], jA) <= max(A_BOUND, sens)
    assert rel(out["u"], ju) <= max(U_BOUND, sens)
    assert rel(out["A_st"], A1) <= A_BOUND
    assert rel(out["u"], u1) <= U_BOUND
    assert len(set(out["iters"])) == 1
    assert (out["iters"][0] is None) == (name == "direct")


@pytest.mark.parametrize("name", ROUTE_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_coarse_routes_match_jax(groups, n, name):
    """The plane-chunked stencil build (``stencil_side_budget_mb=0``; the
    byte rule read on the global P) and the stencil matvec (u gathered a
    matvec) on the slab: against JAX's step of the same configuration on
    its default coarse route."""
    base = cases.ROUTES[name][0]
    ju, jA = jax_ref(base)
    out = group(groups, n)[name]
    assert out["placements"] == ["Shard"] * 2
    assert rel(out["A_st"], jA) <= A_BOUND
    assert rel(out["u"], ju) <= U_BOUND
    assert len(set(out["iters"])) == 1


@pytest.mark.parametrize("name", ["3d-r2-l1", "2d-r4-l2"])
@pytest.mark.parametrize("n", [2, 4])
def test_halo_is_the_slab_alone(groups, n, name):
    """Each rank receives the Phi / A phi canvases of the patches within
    2 l planes of its own, clipped to the domain, and no others."""
    js, _ = jax_solver(name)
    out = group(groups, n)[name]
    P = js.topo.n_patches
    for r in range(n):
        own = (r * P // n, (r + 1) * P // n)
        lo, hi = stencil.stencil_slab(js.cfg, P, own)["patches"]
        assert out["halo_bytes"][r] == (hi - lo - P // n) * out[
            "canvas_bytes"]
        assert 0 < out["halo_bytes"][r] <= (P - P // n) * out[
            "canvas_bytes"]
    if name == "2d-r4-l2":          # 16 planes: every slab is narrower
        assert max(out["halo_bytes"]) < (P - P // n) * out["canvas_bytes"]


def test_uneven_patch_count_replicates_and_warns(groups):
    """16 patches on 3 ranks: every rank computes every patch, the
    outputs are Replicate(), the reference's warning is logged, and the
    result is the single-device step's (and JAX's)."""
    ju, jA = jax_ref("2d-elasticity")
    out = group(groups, 3)["uneven"]
    u1, _ = group(groups, 3)["single"]["2d-elasticity"]
    assert out["placements"] == ["Replicate"] * 2
    assert ("WARNING: leading axis 16 not divisible by 3 devices; array "
            "left replicated") in out["log"]
    assert rel(out["u"], u1) <= U_BOUND
    assert rel(out["A_st"], jA) <= A_BOUND
    assert rel(out["u"], ju) <= U_BOUND


def test_mesh_helpers(groups):
    """On 3 ranks: 6 rows shard 2 a rank, 7 rows replicate (as the
    reference's ``shard_patches``), and ``full_tensor`` gives them back."""
    out = group(groups, 3)["helpers"]
    assert out[6] == ("Shard", 2, True)
    assert out[7] == ("Replicate", 7, True)
    assert out["replicate"]


def test_spawn_raises_a_rank_failure(groups):
    """A rank's exception ends the other rank (waiting in a collective)
    and raises in the caller, with the rank's traceback."""
    kind, msg = groups["failing"].result(timeout=600)
    assert kind == "RuntimeError"
    assert "rank 1 failed" in msg and "raises on purpose" in msg


def test_mesh_refusals(groups):
    """make_mesh with another count than the world size, a mesh without
    the solver's ``mesh_axis`` or without the sweep's axis (ValueError),
    and a mesh that is not a DeviceMesh (TypeError)."""
    out = group(groups, 3)["refusals"]
    assert out["n_devices"][0] == "ValueError"
    assert out["axis"][0] == "ValueError" and "patches" in out["axis"][1]
    assert out["sweep-axis"][0] == "ValueError"
    assert "samples" in out["sweep-axis"][1]
    assert out["not-a-mesh"][0] == "TypeError"


@pytest.mark.parametrize("n", [2, 4])
def test_cg_row_sharded_matches_dense_solve(groups, n):
    """``cg(group=...)`` on a row-sharded SPD system (the counterpart of
    tests/test_distributed_cg.py): the dense solve's x to 1e-9, and every
    rank stopped at the same iteration."""
    out = group(groups, n)["cg"]
    assert all(out["converged"]) and len(set(out["iters"])) == 1
    assert out["iters"][0] <= 64 + 5
    np.testing.assert_allclose(out["x"].numpy(), out["x_ref"], rtol=1e-9,
                               atol=1e-10)


@functools.lru_cache(maxsize=None)
def jax_sweep():
    """JAX's single-device step on each of the sweep's fields."""
    js, step = jax_solver("2d-elasticity")

    class Coefs:                    # the solver's coefficients, as torch's
        coef_q = {k: torch.from_numpy(np.array(v))
                  for k, v in js.coef_q.items()}

    return [tuple(np.asarray(v) for v in step(
        {k: jnp.asarray(v) for k, v in f.items()}, js.fem_rhs))
        for f in cases.sweep_fields(Coefs)]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_sweep_matches_jax(groups, n):
    """``sweep_step(solver, mesh, axis="samples")``: 4 samples, 4 / n a
    rank, Shard(0); each sample against JAX's single-device step on its
    field and the unsharded sweep."""
    ref = jax_sweep()
    out = group(groups, n)["sweep"]
    assert out["placements"] == "Shard"
    assert out["local_samples"] == [cases.SWEEP_SAMPLES // n] * n
    for i, (ju, jA) in enumerate(ref):
        assert rel(out["A_st"][i], jA) <= A_BOUND
        assert rel(out["u"][i], ju) <= U_BOUND
    u1, A1 = group(groups, 3)["single"]["sweep"]
    assert rel(out["A_st"], A1) <= A_BOUND
    assert rel(out["u"], u1) <= U_BOUND


def jax_script_qoi(monkeypatch):
    """The JAX Monte-Carlo script's per-sample QoIs (unsharded) at
    ``cases.MC_ENV``, and 10x their own change under a 1e-15 relative
    coefficient change."""
    for k, v in cases.MC_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MC_SHARD", raising=False)
    calls, jit = [], jax.jit

    def recording_jit(fn):
        step = jit(fn)

        def run(coefs, rhs):
            out = step(coefs, rhs)
            calls.append((step, coefs, rhs, float(jnp.mean(out[0]))))
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    spec = importlib.util.spec_from_file_location(
        "jax_example_monte_carlo",
        os.path.join(REPO, "examples", "monte_carlo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    monkeypatch.setattr(jax, "jit", jit)
    rng = np.random.default_rng(0)
    sens = 0.0
    for step, coefs, rhs, q in calls[1:]:
        pert = {k: v * (1 + 1e-15 * rng.standard_normal(v.shape))
                for k, v in coefs.items()}
        sens = max(sens, abs(float(jnp.mean(step(pert, rhs)[0])) - q)
                   / abs(q))
    return [q for *_, q in calls[1:]], 10 * sens


def test_mc_shard_matches_the_jax_script(groups, monkeypatch):
    """MC_SHARD=2 (the example's ``main`` in a 2-rank group): 2 samples a
    rank, the JAX MC_SHARD branch's lines from rank 0, and the per-sample
    QoIs of the JAX script's unsharded run within max(1e-10, 10x the
    script's own change under a 1e-15 coefficient change)."""
    ref, sens = jax_script_qoi(monkeypatch)
    out = group(groups, 2)["mc"]
    assert out["samples_per_rank"] == [2, 2]
    assert len(out["qoi"]) == len(ref) == 4
    err = max(abs(a - b) / abs(b) for a, b in zip(out["qoi"], ref))
    assert err <= max(1e-10, sens), (err, sens)
    for head in ("config: dim=2 refine=2 patches=16", "sharded over 2 ranks",
                 "first call (once):", "batch of 4:", "QoI mean(u_H):"):
        assert head in out["log"], head
