"""The three routes that the 32768-patch diffusion configuration
(``slodbench/configs/diffusion-3d-32768.json``) takes and no smaller
configuration does, held to the benchmark's plain reference
(``slodbench/reference/slod.py``) on the CPU: the per-chunk coefficient
windows (``window_chunk="on"``), the K-chunked stencil build at C = 1
(``stencil_plan`` patched to four K-chunks) and the stencil-matvec coarse
CG (``coarse_dense_cap`` below P), together, at 3D refine-2, l = 2, in
float64 with the float32 spectral rule (32 smallk directions, jitter
1e-6: the configuration's float32), on seeded random fields.

The bound, 1e-6 on the relative L2 gap of the prolonged fine field, is
``slodbench/tests/test_slodbench_reference.py``'s: these SLOD fields are
rounding-sensitive (the smallk truncation acts as a gauge), the gaps read
1e-10 to 2e-8, and 1e-6 still fails a field without the stabilization or
the rhs by orders of magnitude.  ~10 s on one worker."""

import contextlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu_torch.models import basis, stencil
from dealii_slod_tpu_torch.ops import eig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "slodbench")
BOUND = 1e-6


def reference_module():
    path = os.path.join(BENCH, "reference", "slod.py")
    spec = importlib.util.spec_from_file_location("slodbench_reference_slod",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def settings():
    """The configuration's settings at 3D refine-2 (4^3 coarse cells, 64
    patches), l = 2, float64, chunks of 16 patches (four x-rows each), the
    coarse CG to 1e-15 (its 1e-6 stop alone moves the field ~1e-6 from
    the reference's exact solve) and the three routes forced."""
    with open(os.path.join(BENCH, "configs", "diffusion-3d-32768.json")) as f:
        st = dict(json.load(f)["settings"])
    st.update(n_global_refinements=2, coef_refinement=3, dtype="float64",
              eig_solver="smallk", patch_chunk=16, window_chunk="on",
              coarse_dense_cap=32,
              coarse_solver=pt.ReductionControl(4000, 1e-15, 1e-15))
    return st


@contextlib.contextmanager
def float32_rule():
    """The port's float64 path with the float32 spectral rule (jitter
    1e-6, ``smallk_dirs`` directions)."""
    k_eff, jitter = basis.smallk_k_eff, eig.JITTER[torch.float64]
    basis.smallk_k_eff = lambda cD, dtype, dirs: k_eff(cD, torch.float32,
                                                       dirs)
    eig.JITTER[torch.float64] = eig.JITTER[torch.float32]
    try:
        yield
    finally:
        basis.smallk_k_eff, eig.JITTER[torch.float64] = k_eff, jitter


def field(n_fine: int, dim: int, seed: int) -> torch.Tensor:
    """Alpha(1, 100): one i.i.d. uniform value a fine cell, at its 2^dim
    Gauss points (n_fine^dim, 2^dim)."""
    v = np.random.default_rng(seed).uniform(1.0, 100.0, n_fine ** dim)
    return torch.as_tensor(np.repeat(v[:, None], 2 ** dim, axis=1))


def spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def wrapped(*a, **kw):
        seen.append((name, a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def ref_mod():
    return reference_module()


@pytest.mark.parametrize("seed", [21, 22])
def test_forced_routes_match_the_reference(seed, ref_mod, monkeypatch):
    st = settings()
    cfg = pt.SLODConfig(**st)
    monkeypatch.setattr(stencil, "stencil_plan", lambda *a: ("cells", 4))
    seen = []
    spy(monkeypatch, basis, "window_stack_chunk", seen)
    spy(monkeypatch, stencil, "stencil_build_cells", seen)
    spy(monkeypatch, stencil, "coarse_matvec_with", seen)
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False, eig_block=1)
    P = s.topo.n_patches
    assert P == 64 and cfg.coarse_dense_cap < P
    f = s.assemble_fine_rhs()
    alpha = field(cfg.n_coarse * cfg.n_subdivisions, cfg.dim, seed)
    with float32_rule():
        s.build_step()({"alpha": alpha}, f)
    u = s.prolong_lod_solution()

    # every route ran: each chunk's windows cut from the lattice, the
    # build in four K-chunks, the CG's matvec on the stencil
    names = [n for n, _, _ in seen]
    assert names.count("window_stack_chunk") == P // cfg.patch_chunk
    assert [kw.get("n_chunks") for n, _, kw in seen
            if n == "stencil_build_cells"] == [4]
    assert names.count("coarse_matvec_with") >= int(s.coarse_cg.n_iter) > 1

    ref = ref_mod.ReferenceSLOD(cfg.dim, cfg.n_coarse, cfg.n_subdivisions,
                                cfg.oversampling, 1, "cpu", torch.float64,
                                rule="float32", smallk_dirs=st["smallk_dirs"],
                                smallk_power=st["smallk_power"])
    ref.build({"alpha": alpha})
    v = ref.solve(ref.load_vector([1.0]))
    gap = float(torch.linalg.norm(u.double().reshape(-1) - v.reshape(-1))
                / torch.linalg.norm(v))
    assert gap < BOUND, gap
    # the field is real work: far from the plain LOD reference's
    lod = ref_mod.ReferenceSLOD(cfg.dim, cfg.n_coarse, cfg.n_subdivisions,
                                cfg.oversampling, 1, "cpu", torch.float64,
                                rule="float32", slod=False)
    w = lod.build({"alpha": alpha}).solve(lod.load_vector([1.0]))
    assert float(torch.linalg.norm(w.reshape(-1) - v.reshape(-1))
                 / torch.linalg.norm(v)) > 1e3 * BOUND
