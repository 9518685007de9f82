"""The device lognormal sampler, the sample-axis sweep and the Monte-Carlo
example of the port against the JAX package, float64 on the CPU.

The sampler's noise-to-field part (``lognormal_from_noise``) is fed the
noise JAX's ``lognormal_lattice_batch`` draws (the jax PRNG has no torch
counterpart) and gives its fields to 1e-12; the sampler itself is held to
the parameterization's statistics and to its seed.  ``sweep_step`` equals
per-sample steps and JAX's ``sweep_step`` on the same numpy fields to
1e-10.  The example's per-sample QoIs (mean(u_H)) are held to the JAX
script's on the same fields.  On the CPU both run the eigh spectral
stage, and mean(u_H) there depends on how a LAPACK eigensolver resolves
the Grams' clustered eigenvalues (SLOD's truncation turns that into a
gauge, and at a truncation that flips, into a changed basis): JAX's own
QoI moves by up to ~4.4e-9 relative when its coefficients move by 1e-15
relative, and the port's moves by up to ~8.7e-7 (a lognormal sample)
when its eigh runs on numpy's LAPACK in place of torch's.  So the bound
is 10x the larger of those two changes, both measured in the test, and
never below 1e-10."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu.config import SLODConfig as JaxConfig
from dealii_slod_tpu.models import DiffusionProblem as JaxDiffusion
from dealii_slod_tpu.models import LODSolver as JaxLOD
from dealii_slod_tpu.models import coefficients as jax_coefficients
from dealii_slod_tpu.models.coefficients import RandomField
from dealii_slod_tpu.parallel import sweep as jax_sweep
from dealii_slod_tpu_torch.examples import monte_carlo
from dealii_slod_tpu_torch.models import coefficients
from dealii_slod_tpu_torch.parallel import stack_fields, sweep_step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dim, refinement, corr", [(2, 5, 0.1), (3, 3, 0.2)])
def test_noise_to_field_matches_jax(dim, refinement, corr):
    """JAX's ``lognormal_lattice_batch`` and the port's
    ``lognormal_from_noise`` on the noise JAX draws with the same key: the
    same (S, N^dim) fields to 1e-12 relative."""
    key = jax.random.PRNGKey(7)
    N, S = 2 ** refinement, 4
    ref = jax_coefficients.lognormal_lattice_batch(
        key, S, refinement, dim, 1.0, 100.0, corr_len=corr)
    noise = np.array(jax.random.normal(key, (S,) + (N,) * dim))
    out = coefficients.lognormal_from_noise(torch.as_tensor(noise), 1.0,
                                            100.0, corr_len=corr)
    assert out.shape == (S, N ** dim)
    assert rel(out, ref) <= 1e-12


def test_sampler_statistics_and_seed():
    """``lognormal_lattice_batch`` on the CPU: positive (8, 1024) fields
    whose log-mean and log-std lie within 0.6 and 0.3 of the
    parameterization (``tests/test_lognormal.py``'s bounds); the same
    generator seed gives the same fields, another seed others."""
    def draw(seed):
        return coefficients.lognormal_lattice_batch(
            torch.Generator().manual_seed(seed), 8, 5, 2, 1.0, 100.0,
            corr_len=0.1, device="cpu")

    v = draw(0)
    assert v.shape == (8, 1024) and v.dtype == torch.float64
    assert bool((v > 0).all())
    lg = torch.log(v)
    mu, sigma = 0.5 * np.log(100.0), 0.25 * np.log(100.0)
    assert abs(float(lg.mean()) - mu) < 0.6
    assert abs(float(lg.std(correction=0)) - sigma) < 0.3
    assert torch.equal(draw(0), v)
    assert not torch.equal(draw(1), v)


SWEEP = dict(dim=2, n_global_refinements=2, n_subdivisions=2,
             oversampling=1, lod_stabilization=True,
             constant_coefficients=False, coef_seed=0, coef_refinement=3,
             coef_min=1.0, coef_max=50.0)


def fields(qpts, n):
    """``tests/test_sweep.py``'s fields: numpy-seeded random fields at the
    quadrature points."""
    return [{"alpha": RandomField(1.0, 50.0, 3, 2, seed=s,
                                  sampler="numpy")(qpts)} for s in range(n)]


@pytest.fixture(scope="module")
def sweeps():
    """JAX's and the port's sweep over the same 3 fields, and the port's
    solver and fields."""
    js = JaxLOD(JaxConfig(**SWEEP), JaxDiffusion(JaxConfig(**SWEEP)),
                verbose=False)
    js.assemble_fine_rhs()
    fs = fields(np.asarray(js.qpts), 3)
    ju, jA = jax_sweep.sweep_step(js)(
        jax_sweep.stack_fields([{k: jnp.asarray(v) for k, v in f.items()}
                                for f in fs]), js.fem_rhs)
    cfg = pt.SLODConfig(**SWEEP)
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    s.assemble_fine_rhs()
    u, A_st = sweep_step(s)(stack_fields(fs), s.fem_rhs)
    return dict(ju=np.asarray(ju), jA=np.asarray(jA), u=u, A_st=A_st, s=s,
                fields=fs)


def test_sweep_matches_per_sample_steps(sweeps):
    """Sample s of the sweep is a lone step on field s, to 1e-10; the
    results lie on the solver's device, with a leading sample axis."""
    s = sweeps["s"]
    assert sweeps["u"].shape == (3, 16, 1)
    assert sweeps["A_st"].shape == (3, 16, s.n_stencil, 1, 1)
    assert sweeps["u"].device == s.device
    step = s.build_step()
    for i, f in enumerate(sweeps["fields"]):
        u, A_st = step({k: torch.as_tensor(v) for k, v in f.items()},
                       s.fem_rhs)
        assert rel(sweeps["u"][i], u) <= 1e-10
        assert rel(sweeps["A_st"][i], A_st) <= 1e-10


def test_sweep_matches_jax(sweeps):
    """The port's sweep against JAX's vmapped ``sweep_step`` on the same
    numpy fields: u and A_st to 1e-10."""
    assert rel(sweeps["u"], sweeps["ju"]) <= 1e-10
    assert rel(sweeps["A_st"], sweeps["jA"]) <= 1e-10


def test_stack_fields():
    a = {"alpha": np.ones((4, 2)), "creact": np.zeros((4, 2))}
    out = stack_fields([a, a, a])
    assert sorted(out) == ["alpha", "creact"]
    assert out["alpha"].shape == (3, 4, 2)


def test_sharded_sweep_raises():
    """A ``mesh`` that is not a torch ``DeviceMesh`` raises ``TypeError``
    (``tests/test_torch_sharding.py`` holds the sharded sweep itself)."""
    cfg = pt.SLODConfig(**SWEEP)
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sweep_step(s, mesh=object(), axis="samples")


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_example_monte_carlo",
        os.path.join(REPO, "examples", "monte_carlo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("field", ["random", "lognormal"])
def test_monte_carlo_matches_the_jax_script(field, monkeypatch, capsys):
    """``monte_carlo --device cpu`` against the JAX script at MC_DIM=2
    MC_REFINE=3 MC_SAMPLES=3 in float64: the same fields (to 1e-12) and
    the per-sample QoIs within max(1e-10, 10x the larger of JAX's own QoI
    change under a 1e-15 relative coefficient change and the port's under
    another LAPACK's eigh); the printed lines follow the script's.  For
    MC_FIELD=lognormal the port's sampler is given the noise JAX draws, so
    both look up the same lattices."""
    for k, v in dict(MC_DIM="2", MC_REFINE="3", MC_SAMPLES="3",
                     MC_DTYPE="float64", MC_FIELD=field).items():
        monkeypatch.setenv(k, v)
    calls, jit = [], jax.jit

    def recording_jit(fn):
        step = jit(fn)

        def run(coefs, rhs):
            out = step(coefs, rhs)
            calls.append((step, coefs, rhs, float(jnp.mean(out[0]))))
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    jax_script().main()
    monkeypatch.setattr(jax, "jit", jit)
    ref = [q for *_, q in calls[1:]]
    rng = np.random.default_rng(0)
    sens = 0.0
    for step, coefs, rhs, q in calls[1:]:
        pert = {k: v * (1 + 1e-15 * rng.standard_normal(v.shape))
                for k, v in coefs.items()}
        sens = max(sens, abs(float(jnp.mean(step(pert, rhs)[0])) - q)
                   / abs(q))
    capsys.readouterr()

    def jax_noise(generator, S, refinement, dim, *args, **kw):
        kw.pop("device")
        noise = jax.random.normal(jax.random.PRNGKey(0),
                                  (S,) + (2 ** refinement,) * dim)
        return coefficients.lognormal_from_noise(
            torch.as_tensor(np.array(noise)), *args, **kw)

    monkeypatch.setattr(coefficients, "lognormal_lattice_batch", jax_noise)
    res = monte_carlo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(res["qoi"]) == len(ref) == 3
    step, eigh = res["solver"].build_step(), torch.linalg.eigh

    def numpy_eigh(G):
        return tuple(map(torch.as_tensor, np.linalg.eigh(G.numpy())))

    for i, (_, coefs, _, _) in enumerate(calls):
        f = res["field"](i)
        assert rel(f["alpha"], coefs["alpha"]) <= 1e-12
        if i == 0:
            continue
        monkeypatch.setattr(torch.linalg, "eigh", numpy_eigh)
        q = float(step(f, res["solver"].fem_rhs)[0].mean())
        monkeypatch.setattr(torch.linalg, "eigh", eigh)
        sens = max(sens, abs(q - res["qoi"][i - 1]) / abs(q))
    err = max(abs(a - b) / abs(b) for a, b in zip(res["qoi"], ref))
    assert err <= max(1e-10, 10 * sens), (err, sens)
    for line in ("config: dim=2 refine=3 patches=64", "first call (once):",
                 "per-sample: median", "QoI mean(u_H): mean"):
        assert line in out
    assert (res["lattice"] is not None) == (field == "lognormal")
