"""The port keeps its own copies of the JAX package's host-side modules
(``config``, ``grid``, ``ops/element``, ``models/coefficients``,
``utils/io``, ``utils/native`` and ``utils/checkpoint.py``'s fingerprint):
this guard holds each copy equal to its original on 2D and 3D configurations,
so that a change to one side that is not made to the other shows here."""

import dataclasses

import numpy as np
import pytest

from dealii_slod_tpu import config as jax_config
from dealii_slod_tpu import grid as jax_grid
from dealii_slod_tpu.models import coefficients as jax_coefficients
from dealii_slod_tpu.ops import element as jax_element
from dealii_slod_tpu_torch import config, grid
from dealii_slod_tpu_torch.models import coefficients
from dealii_slod_tpu_torch.ops import element

CASES = {"2d-r3-l2": dict(dim=2, n_global_refinements=3, oversampling=2),
         "3d-r2-l1": dict(dim=3, n_global_refinements=2, oversampling=1),
         "3d-r3-l2": dict(dim=3, n_global_refinements=3, oversampling=2)}


def _grids(case):
    kw = CASES[case]
    return [mod.GridSpec(kw["dim"], 2 ** kw["n_global_refinements"], 2, 1)
            for mod in (jax_grid, grid)]


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_config_defaults_match():
    """Every field of ``SLODConfig`` and ``ReductionControl``: the same
    names, in the same order, with the same defaults."""
    for jcls, cls in ((jax_config.SLODConfig, config.SLODConfig),
                      (jax_config.ReductionControl,
                       config.ReductionControl)):
        jf, f = dataclasses.fields(jcls), dataclasses.fields(cls)
        assert [x.name for x in jf] == [x.name for x in f]
        assert dataclasses.asdict(jcls()) == dataclasses.asdict(cls())


def test_parsed_function_and_prm_match():
    pts = np.random.default_rng(0).uniform(0, 1, (5, 7, 3))
    for spec in ("sin(pi*x) * cos(y) + z^2", "1; x + 2 * y"):
        nc = spec.count(";") + 1
        _equal(config.ParsedFunction(spec, nc, 3)(pts),
               jax_config.ParsedFunction(spec, nc, 3)(pts))
    cfg = config.SLODConfig(dim=3, oversampling=2, lod_stabilization=True)
    assert cfg.to_prm() == jax_config.SLODConfig(
        dim=3, oversampling=2, lod_stabilization=True).to_prm()


@pytest.mark.parametrize("case", list(CASES))
def test_grid_tables_match(case):
    """Patch bounds and flags, the canvas shape class (interior nodes, PT,
    connectivity), the global connectivity and a clipped window index."""
    ell = CASES[case]["oversampling"]
    jg, g = _grids(case)
    assert np.isclose(jg.h, g.h) and jg.n_nodes == g.n_nodes
    jt, t = jax_grid.PatchTopology(jg, ell), grid.PatchTopology(g, ell)
    for name in ("patch_lo", "patch_shape", "central_cell_local",
                 "side_is_domain", "origin_nodes", "class_of_patch"):
        _equal(getattr(t, name), getattr(jt, name))
    dim = g.dim
    jsc = jax_grid.ShapeClass((2 * ell + 1,) * dim, jg)
    sc = grid.ShapeClass((2 * ell + 1,) * dim, g)
    for name in ("PT", "interior_nodes", "edge_nodes", "conn",
                 "sub_coords", "node_coords_local", "assembly_flat_idx"):
        _equal(getattr(sc, name), getattr(jsc, name))
    _equal(sc.interior_dof_indices(), jsc.interior_dof_indices())
    _equal(grid.global_connectivity(g), jax_grid.global_connectivity(jg))
    anchor = (grid.cartesian_coords(g.cell_dims) - ell) * 2
    extent = np.full(dim, (2 * ell + 1) * 2 + 1)
    for a, b in zip(grid.clipped_window_index(anchor, extent, g.node_dims),
                    jax_grid.clipped_window_index(anchor, extent,
                                                  jg.node_dims)):
        _equal(a, b)


@pytest.mark.parametrize("dim, C", [(2, 1), (3, 1), (2, 2), (3, 3)])
def test_element_tensors_match(dim, C):
    et, jet = element.ElementTensors(dim, 0.125, C), \
        jax_element.ElementTensors(dim, 0.125, C)
    names = ["V", "G", "w", "K_grad", "R", "M", "points_unit"]
    if C > 1:
        names += ["K_mu", "K_lam", "R_vec"]
    for name in names:
        _equal(getattr(et, name), getattr(jet, name))
    jg, g = _grids("2d-r3-l2" if dim == 2 else "3d-r2-l1")
    _equal(element.quad_points_global(g), jax_element.quad_points_global(jg))


@pytest.mark.parametrize("field", ["random", "constant", "parity",
                                   "channel", "lognormal"])
def test_coefficient_fields_match(field):
    """``make_field`` samples the same field: numpy-seeded random,
    constant, the glibc-parity stream with its draw offset, the channel
    and the lognormal lattice."""
    dim = 2 if field == "channel" else 3
    kw = dict(dim=dim, coef_seed=5, coef_refinement=3,
              constant_coefficients=field == "constant",
              reference_parity=field == "parity",
              coef_rand_offset=12 if field == "parity" else 0,
              coef_field=field if field in ("channel", "lognormal")
              else "random")
    f = coefficients.make_field(config.SLODConfig(**kw), dim)
    jf = jax_coefficients.make_field(jax_config.SLODConfig(**kw), dim)
    pts = np.random.default_rng(1).uniform(0, 1, (200, dim))
    _equal(f(pts), jf(pts))


@pytest.mark.parametrize("module", ["io", "native"])
def test_utils_copies_match(module):
    """``utils/io.py`` and ``utils/native.py``: the same source as the
    originals but for the package name in the imports, the same native
    library path, and the same bytes written for the same fields."""
    import importlib
    import inspect
    mine = importlib.import_module(f"dealii_slod_tpu_torch.utils.{module}")
    ref = importlib.import_module(f"dealii_slod_tpu.utils.{module}")
    assert inspect.getsource(mine).replace(
        "dealii_slod_tpu_torch", "dealii_slod_tpu") == inspect.getsource(ref)
    if module == "native":
        assert mine._LIB_PATH == ref._LIB_PATH



@pytest.mark.parametrize("kw", [{}, dict(dim=3, oversampling=2,
                                         lod_stabilization=True),
                                dict(coef_seed=7, dtype="float32",
                                     eig_solver="smallk")],
                         ids=["default", "3d-slod", "f32-smallk"])
def test_checkpoint_fingerprint_copy_matches(kw):
    """``utils/checkpoint.py: _config_fingerprint``, the one function the
    port copies from that module: the same source, and the same
    fingerprint of the same configuration (so basis files move between
    the packages)."""
    import inspect
    from dealii_slod_tpu.utils import checkpoint as jax_checkpoint
    from dealii_slod_tpu_torch.utils import checkpoint
    assert inspect.getsource(checkpoint._config_fingerprint) == \
        inspect.getsource(jax_checkpoint._config_fingerprint)
    for C in (1, kw.get("dim", 2)):
        assert checkpoint._config_fingerprint(config.SLODConfig(**kw), C) \
            == jax_checkpoint._config_fingerprint(
                jax_config.SLODConfig(**kw), C)
