"""The port's float32 product precision: ``LODSolver`` turns TF32 off for
cuBLAS and cuDNN only around its own work on the card and gives the
caller's flags back afterwards, also when the work raises; a
``matmul_precision`` the port does not honour warns.  CPU only: the flags
are plain process settings, readable and settable without a card."""

import contextlib
import warnings

import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu_torch.models.lod import _full_f32, full_f32_matmuls

FLAGS = (torch.backends.cuda.matmul, torch.backends.cudnn)


@pytest.fixture
def caller_flags():
    """Saves the process's two flags and puts them back after the test."""
    saved = [f.allow_tf32 for f in FLAGS]
    yield
    for f, v in zip(FLAGS, saved):
        f.allow_tf32 = v


def _set(mm, dnn):
    FLAGS[0].allow_tf32, FLAGS[1].allow_tf32 = mm, dnn


def _read():
    return tuple(f.allow_tf32 for f in FLAGS)


@pytest.mark.parametrize("raises", [False, True])
@pytest.mark.parametrize("mm, dnn", [(False, False), (False, True),
                                     (True, False), (True, True)])
def test_full_f32_matmuls_restores_flags(caller_flags, mm, dnn, raises):
    _set(mm, dnn)
    inside = None
    with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
        with full_f32_matmuls():
            inside = _read()
            if raises:
                raise RuntimeError("fails inside the block")
    assert inside == (False, False)
    assert _read() == (mm, dnn)


class _Stub:
    """A solver's ``device`` and one stage, run the way ``LODSolver`` runs
    its public stages and its step."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seen = None

    @_full_f32
    def stage(self, fail):
        self.seen = _read()
        if fail:
            raise ValueError("the stage fails")
        return "done"


@pytest.mark.parametrize("fail", [False, True])
def test_stage_on_the_card_scopes_the_flags(caller_flags, fail):
    """On a CUDA device the stage runs with TF32 off; the caller's True
    flags come back whether it returns or raises."""
    _set(True, True)
    s = _Stub("cuda")
    if fail:
        with pytest.raises(ValueError):
            s.stage(True)
    else:
        assert s.stage(False) == "done"
    assert s.seen == (False, False)
    assert _read() == (True, True)


def test_stage_on_the_cpu_leaves_the_flags(caller_flags):
    _set(True, True)
    s = _Stub("cpu")
    s.stage(False)
    assert s.seen == (True, True) and _read() == (True, True)


def test_step_and_stages_are_scoped():
    """The step ``build_step`` returns and every public stage that runs
    products on the card go through ``_full_f32``."""
    for name in ("_step", "assemble_fine_rhs", "compute_basis",
                 "assemble_coarse_operator", "coarse_dense_matrix",
                 "solve_coarse", "prolong_lod_solution"):
        fn = getattr(pt.LODSolver, name)
        assert fn.__code__ is _full_f32(lambda: None).__code__, name


def _solver(precision):
    cfg = pt.SLODConfig(dim=2, n_global_refinements=2, n_subdivisions=2,
                        oversampling=1, lod_stabilization=True,
                        dtype="float64", eig_solver="jacobi",
                        matmul_precision=precision)
    return pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                        verbose=False)


def test_unhonoured_precision_warns():
    with pytest.warns(UserWarning, match="matmul_precision='default'.*"
                      "full-float32"):
        _solver("default")


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_honoured_precision_does_not_warn(precision):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _solver(precision)

