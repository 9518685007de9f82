"""The roofline arithmetic gives the kernel table's bounds (PERF.md) at
the table's shapes, and the basis stage's contract count stays within
the work the kernels that do it are counted with, so no share it feeds
can read over 100%."""

import pytest

import harness
import roofline

MAIN = roofline.basis_args(harness.resolve(
    "diffusion-3d-4096.samples")["config"])
EL = roofline.basis_args(harness.resolve(
    "elasticity-3d-4096.samples")["config"])


def test_table_bounds():
    assert roofline.by(*roofline.k1_work(128, 729, 125))[0] == \
        pytest.approx(0.5441, abs=1e-4)
    t, what = roofline.by(*roofline.trace_work(128, 1, 1331, 1597, 125, 27))
    assert (round(t, 4), what) == (0.0614, "bytes")
    assert roofline.by(*roofline.k6_work(128, 768, 1794))[0] == \
        pytest.approx(4.3315, abs=1e-4)
    assert roofline.by(*roofline.k2_work(128, 125))[0] == \
        pytest.approx(0.0075, abs=1e-4)


def test_launch_work_reads_the_sizes():
    k1 = (0, 0, 0, 0, 128, 768, 128)
    assert roofline.launch_work("slod_fused_spd_multirhs", 4, k1) == \
        roofline.k1_work(128, 768, 128)
    k6 = (0, 0, 0, 128, 768, 1794)
    assert roofline.launch_bound_s("slod_spd_multirhs_solve", 4, k6) == \
        pytest.approx(roofline.by(*roofline.k6_work(128, 768, 1794),
                                  495e12 / 3)[0] / 1e3)
    assert roofline.launch_work("slod_something_new", 4, ()) is None


def test_basis_contract_within_the_kernel_rows():
    """Main path, 32 chunks of 128: the patch solves need no more than 32
    K1 rows at (128, 729, 125), the traces no more than 64 K3 rows (S and
    A phi), T^-1 and (G + delta I)^-1 no more than 64 K2 rows, the QR
    steps no more than 96 K4 rows at (128, 125, 32)."""
    p = roofline.basis_parts(**MAIN)
    assert p["patch_solve"][0] <= 32 * roofline.k1_work(128, 729, 125)[0]
    assert p["trace"][0] <= 64 * roofline.trace_work(
        128, 1, 1331, 1597, 125, 27)[0]
    assert p["t_inverse"][0] + p["g_inverse"][0] <= 64 * roofline.k2_work(
        128, 125)[0]
    qr_only = 3 * 4096 * 4 * 125 * 32 ** 2
    assert qr_only <= 96 * roofline.k4_work(128, 125, 32)[0]
    # and every part is counted: the stage's least time is the bulk of
    # the patch solves' at these shapes
    total = roofline.basis_work(**MAIN)[0]
    assert p["patch_solve"][0] < total < 2 * p["patch_solve"][0]


def test_elasticity_contract_within_the_split():
    """Elasticity: the patch solves need no more than one unsplit solve of
    the padded 2240 block a patch with its 384 right-hand sides."""
    p = roofline.basis_parts(**EL)
    assert p["patch_solve"][0] <= 4096 * (2240 ** 3 / 3 + 2 * 2240 ** 2
                                          * 384 + 2 * 2240 * 384 ** 2)
    assert p["patch_solve"][0] > 0.5 * 4096 * (2187 ** 3 / 3)
