"""K1 on the whole patch block, factored in place on the padded operand
that ``basis.prep`` assembles (the card's float32 route):
``models/lod.py: patch_solver_mode``'s card rule as a pure function, the
padded operand of each assembly route against the padded copy of the
block it replaces, the CPU's plain solve of that operand, and the
``patch_solve.patches`` / ``patch_solve.whole_block`` counters.  Tiny
3D configurations on the CPU; a few seconds on one worker."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_trace import traced

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu_torch.grid import GridSpec, ShapeClass, cartesian_coords
from dealii_slod_tpu_torch.models import basis
from dealii_slod_tpu_torch.models.lod import K1_WHOLE_MAX_N, patch_solver_mode
from dealii_slod_tpu_torch.ops import assembly, patch_solve
from dealii_slod_tpu_torch.utils import timers

torch.set_num_threads(2)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def rule(C, ell, device, dtype="float32", patch_solver="auto", dim=3):
    cfg = pt.SLODConfig(dim=dim, n_global_refinements=3, oversampling=ell,
                        dtype=dtype, patch_solver=patch_solver)
    grid = GridSpec(dim, cfg.n_coarse, cfg.n_subdivisions, C)
    return patch_solver_mode(cfg, C, ShapeClass((2 * ell + 1,) * dim, grid),
                             device)


def test_card_rule_takes_the_whole_elasticity_block():
    """3D l = 2 at C = 3 (2187 -> 2240): K1 on the whole block on a CUDA
    device in float32."""
    assert patch_solve.k1_operand_n(3 * 9 ** 3) == 2240 <= K1_WHOLE_MAX_N
    assert rule(3, 2, CUDA) == rule(3, 2, "cuda") == "fused"


@pytest.mark.parametrize("device,dtype", [(CPU, "float32"),
                                          (CPU, "float64"),
                                          (CUDA, "float64"),
                                          (None, "float32")])
def test_reference_rule_off_the_card_or_in_float64(device, dtype):
    """The CPU, float64 or no device: the reference's size rule, the Schur
    split at 3D l = 2, C = 3."""
    assert rule(3, 2, device, dtype) == "fused_split"


@pytest.mark.parametrize("device,dtype", [(CPU, "float32"),
                                          (CPU, "float64"),
                                          (CUDA, "float32"),
                                          (CUDA, "float64")])
def test_diffusion_block_is_fused_everywhere(device, dtype):
    """3D l = 2 at C = 1 (729 -> 768) fits the reference's estimate:
    "fused" on every device and dtype."""
    assert rule(1, 2, device, dtype) == "fused"


def test_block_past_the_constant_takes_the_reference_rule():
    """3D l = 3 at C = 3 (6591 -> 6592) is past ``K1_WHOLE_MAX_N``: the
    reference's rule (the per-patch Cholesky solve) on the card too;
    3D l = 3 at C = 1 (2197 -> 2240) is not."""
    assert patch_solve.k1_operand_n(3 * 13 ** 3) > K1_WHOLE_MAX_N
    assert rule(3, 3, CUDA) == rule(3, 3, CPU) == "lax"
    assert rule(1, 3, CPU) == "fused_split"
    assert rule(1, 3, CUDA) == "fused"


def test_named_solver_is_taken_as_it_is_on_the_card():
    assert rule(3, 2, CUDA, patch_solver="fused_split") == "fused_split"
    assert rule(3, 2, CUDA, patch_solver="panel") == "panel"
    assert rule(1, 2, CUDA, patch_solver="lax") == "lax"


def masked_band(dims, C, B=3, seed=0):
    """Random bands (B, nN, 3^dim[, C, C]) with zero weight on the
    neighbours off the grid, as ``basis.prep`` masks them."""
    dims = np.asarray(dims)
    nodes = cartesian_coords(dims)
    offs = cartesian_coords(np.full(len(dims), 3)) - 1
    nb = nodes[:, None, :] + offs[None]
    ok = torch.as_tensor(((nb >= 0) & (nb < dims)).all(-1), dtype=torch.float64)
    g = torch.Generator().manual_seed(seed)
    shape = (B, len(nodes), len(offs)) + ((C, C) if C > 1 else ())
    band = torch.randn(shape, generator=g, dtype=torch.float64)
    return band * (ok[None, :, :, None, None] if C > 1 else ok[None])


@pytest.mark.parametrize("dims,C", [((5, 5, 5), 1), ((5, 5, 5), 3),
                                    ((4, 4, 4), 1), ((7, 5), 2)])
def test_padded_embedding_equals_the_padded_copy(dims, C):
    """``bands_to_dense_mm(..., n=)`` against ``_pad_spd`` of the
    unpadded embedding: value for value (``torch.equal``; a masked
    placement's zero may carry the other sign), contiguous, at
    a 64-element offset of its storage; (4, 4, 4) at C = 1 is a block
    that needs no padding (n = nN C = 64: the copied route)."""
    P, shift, nN = assembly.band_placement_matrix(np.asarray(dims))
    band = masked_band(dims, C)
    n = patch_solve.k1_operand_n(nN * C)
    A = assembly.bands_to_dense_mm(band, P, shift, nN)
    Ap = assembly.bands_to_dense_mm(band, torch.as_tensor(P), shift, nN, n=n)
    assert Ap.shape == (band.shape[0], n, n) and Ap.is_contiguous()
    assert Ap.storage_offset() % 64 == 0
    assert torch.equal(Ap, patch_solve._pad_spd(A, n))


def solver(elastic, **kw):
    """3D, 4^3 coarse cells, l = 1 (blocks 125 / 375 -> 128 / 384),
    chunks of 8 patches, on the CPU."""
    cfg = pt.SLODConfig(**{**dict(
        dim=3, n_global_refinements=2, oversampling=1,
        lod_stabilization=True, constant_coefficients=False, coef_seed=3,
        patch_chunk=8, eig_solver="smallk", dtype="float64",
        rhs="1; 1; 1" if elastic else "1"), **kw})
    problem = (pt.ElasticityProblem if elastic else pt.DiffusionProblem)(cfg)
    return pt.LODSolver(cfg, problem, device="cpu", verbose=False)


def chunk_of(s, p0=24, B=8):
    """The coefficient windows and window bounds of patches p0 .. p0+B-1
    (an interior chunk: some masked rows, some whole windows)."""
    tab = s._uniform_tables()
    _, nlo, nhi, _ = s._uniform_inputs()
    sel = slice(p0, p0 + B)
    cw = {k: basis.coef_windows(s.cfg, s.grid, s.coef_q[k])[sel]
          for k in tab.coef_names}
    return tab, cw, torch.as_tensor(nlo[sel]), torch.as_tensor(nhi[sel])


@pytest.mark.parametrize("assembly_mode", ["banded", "scatter"])
@pytest.mark.parametrize("elastic", [False, True])
def test_prep_assembles_the_padded_operand(elastic, assembly_mode):
    """Each assembly route that feeds K1, at C = 1 and C = 3: with
    ``k1_n`` set, ``prep``'s A_solve is ``_pad_spd`` of the block it
    assembles without (``torch.equal``), the other outputs unchanged; on
    the CPU the tables leave ``k1_n`` unset."""
    s = solver(elastic, assembly_mode=assembly_mode, patch_solver="fused")
    tab, cw, nlo, nhi = chunk_of(s)
    assert tab.k1_n == 0
    n = patch_solve.k1_operand_n(tab.nI)
    assert n > tab.nI
    out = basis.prep(tab, cw, nlo, nhi)
    padded = basis.prep(dataclasses.replace(tab, k1_n=n), cw, nlo, nhi)
    assert padded[1].shape == (8, n, n) and padded[1].is_contiguous()
    assert torch.equal(padded[1], patch_solve._pad_spd(out[1], n))
    for a, b in zip(out[:1] + out[2:], padded[:1] + padded[2:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("elastic", [False, True])
def test_patch_solve_on_the_padded_operand(elastic):
    """On the CPU the plain version solves the padded operand's leading
    block: X and T equal the unpadded route's; under a profiler the chunk
    counts its patches, and the whole block in place only where ``k1_n``
    is set."""
    s = solver(elastic, patch_solver="fused")
    tab, cw, nlo, nhi = chunk_of(s)
    pad = dataclasses.replace(tab, k1_n=patch_solve.k1_operand_n(tab.nI))
    _, A, PT_m, _ = basis.prep(tab, cw, nlo, nhi)
    _, Ap, _, _ = basis.prep(pad, cw, nlo, nhi)
    with traced():
        X, T = basis.patch_solve(tab, A, PT_m)
    assert timers.counters() == {"patch_solve.patches": {None: 8}}
    with traced():
        Xp, Tp = basis.patch_solve(pad, Ap, PT_m)
    assert timers.counters() == {"patch_solve.patches": {None: 8},
                                 "patch_solve.whole_block": {None: 8}}
    timers.clear()
    torch.testing.assert_close(Xp, X, rtol=1e-14, atol=0)
    torch.testing.assert_close(Tp, T, rtol=1e-14, atol=0)


def test_basis_counts_every_chunk():
    """A CPU basis build on the Schur split counts each chunk's patches
    under the ``patch_solve`` span and no whole block."""
    s = solver(False, patch_solver="fused_split")
    with traced():
        s.compute_basis(s.coef_q)
    c = timers.counters()
    timers.clear()
    assert c["patch_solve.patches"] == {"patch_solve": s.topo.n_patches}
    assert "patch_solve.whole_block" not in c


def test_in_place_operand_shape_is_checked():
    """K1's in-place operand must be (P, n, n) at B's padded n."""
    A, B = torch.zeros((2, 100, 100)), torch.zeros((2, 100, 7))
    with pytest.raises(ValueError, match="in place"):
        patch_solve._ldl_operands("fused_spd_multirhs", A, B, in_place=True)
    with pytest.raises(ValueError, match="do not match"):
        patch_solve._ldl_operands("fused_spd_multirhs",
                                  torch.zeros((2, 128, 128)), B)
