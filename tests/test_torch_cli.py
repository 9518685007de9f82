"""The port's command-line application against the JAX package's: the
same arguments (plus ``--device``), the same default parameter file, a
``--device cpu`` run with rc 0 and its output files, VTU arrays equal to
the reference's, and ``reaction``'s run beside the reference's; and the
copied VTU writers (``utils/io.py``, ``utils/native.py``) read back."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from dealii_slod_tpu import cli as jax_cli
from dealii_slod_tpu import grid as jax_grid
from dealii_slod_tpu.utils import io as jax_io
from dealii_slod_tpu_torch import cli, grid
from dealii_slod_tpu_torch.utils import io

torch.set_num_threads(2)

VTU = ("solution_fine.vtu", "solution_coarse.vtu",
       "solution_coefficients.vtu")
_TYPES = {"Float64": np.float64, "Int64": np.int64, "UInt8": np.uint8}


def read_vtu(path):
    """name -> array of every DataArray of a VTU file, ASCII or the native
    writer's appended raw binary (each block a uint64 byte count and its
    payload); the points under "Points"."""
    raw = open(path, "rb").read()
    appended = b"<AppendedData" in raw
    head = raw.split(b"<AppendedData", 1)[0].decode() + "</VTKFile>" \
        if appended else raw.decode()
    blob = None
    if appended:
        blob = raw.split(b'encoding="raw">', 1)[1]
        blob = blob[blob.index(b"_") + 1:]
    out = {}
    for d in ET.fromstring(head).iter("DataArray"):
        dt = _TYPES[d.get("type")]
        if appended:
            off = int(d.get("offset"))
            n = int(np.frombuffer(blob[off:off + 8], dtype=np.uint64)[0])
            v = np.frombuffer(blob[off + 8:off + 8 + n], dtype=dt)
        else:
            v = np.array(d.text.split(), dtype=np.float64).astype(dt)
        out[d.get("Name") or "Points"] = v
    return out


def options(parser):
    return {(tuple(a.option_strings), a.dest, a.default,
             tuple(a.choices) if a.choices else None, a.nargs)
            for a in parser._actions}


def test_parser_matches_the_reference_plus_device():
    """Every argument of the reference's parser, with its default and
    choices, and ``--device {cuda,cpu}`` defaulting to the card."""
    mine, ref = options(cli.build_parser()), options(jax_cli.build_parser())
    assert mine - ref == {(("--device",), "device", "cuda",
                           ("cuda", "cpu"), None)}
    assert ref <= mine


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' first run (missing .prm) for 2D diffusion on the CPU, in
    directories of their own -> (port dir, JAX dir, port rc)."""
    here = os.getcwd()
    dirs = {}
    try:
        for name, main, argv in (
                ("port", cli.main, ["diffusion", "--device", "cpu"]),
                ("jax", jax_cli.main, ["diffusion"])):
            d = tmp_path_factory.mktemp(name)
            os.chdir(d)
            dirs[name] = (d, main(argv))
    finally:
        os.chdir(here)
    return dirs


def test_device_cpu_run_writes_its_files(runs):
    d, rc = runs["port"]
    assert rc == 0
    for f in ("parameters.prm", "used_parameters_2.prm") + VTU:
        assert (d / f).stat().st_size > 0


def test_default_prm_matches_the_reference(runs):
    """The parameter file written on a first run (with the CPU's float64)
    and the used-parameters dump are the reference's."""
    (d, _), (jd, _) = runs["port"], runs["jax"]
    for f in ("parameters.prm", "used_parameters_2.prm"):
        assert (d / f).read_text() == (jd / f).read_text()


@pytest.mark.parametrize("name", VTU)
def test_vtu_arrays_match_the_reference(runs, name):
    """The same arrays (points, cells, the fine / coarse / coefficient
    fields) as the reference's files, to 1e-10 relative."""
    a = read_vtu(runs["port"][0] / name)
    b = read_vtu(runs["jax"][0] / name)
    assert list(a) == list(b)
    for key in b:
        assert a[key].shape == b[key].shape, key
        scale = max(float(np.abs(b[key]).max()), 1e-300)
        assert float(np.abs(a[key].astype(np.float64)
                            - b[key].astype(np.float64)).max()) \
            <= 1e-10 * scale, key


def test_reaction_is_refused(tmp_path, monkeypatch, capsys):
    """``reaction`` was refused until reaction-diffusion was ported; now
    both CLIs run it (first run, defaults, c = 1) on the CPU with rc 0 and
    no exception report, and its VTU arrays equal the reference's to
    1e-10 relative."""
    for name, main, argv in (
            ("port", cli.main, ["reaction", "--device", "cpu"]),
            ("jax", jax_cli.main, ["reaction"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(argv) == 0
        assert "Exception on processing" not in capsys.readouterr().err
    for f in VTU:
        a = read_vtu(tmp_path / "port" / f)
        b = read_vtu(tmp_path / "jax" / f)
        assert list(a) == list(b)
        for key in b:
            scale = max(float(np.abs(b[key]).max()), 1e-300)
            assert float(np.abs(a[key].astype(np.float64)
                                - b[key].astype(np.float64)).max()) \
                <= 1e-10 * scale, (f, key)


def test_existing_prm_and_options(tmp_path, monkeypatch):
    """An existing .prm is read (the SLOD switch and l = 2 are taken), the
    command-line options override it, and ``--no-output`` writes no VTU."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "p.prm").write_text(
        "subsection Problem\n"
        "  set Oversampling = 2\n"
        "  set Number of global refinements = 3\n"
        "  set Stabilize phi_LOD candidates = true\n"
        "end\n")
    assert cli.main(["diffusion", "p.prm", "--device", "cpu", "--no-output",
                     "--no-fine-solve", "--chunk", "16"]) == 0
    assert not any(tmp_path.glob("*.vtu"))
    assert not (tmp_path / "used_parameters_2.prm").exists()


def test_cli_on_cuda_without_a_card_reports(tmp_path, monkeypatch, capsys):
    """The default device is the card: without one, rc 1 and the report."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["diffusion", "--no-output"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_vtu_writers_match_the_reference(tmp_path):
    """The copied writers (``utils/io.py``, with ``utils/native.py``'s
    binary writer where the library loads) write the same arrays as the
    originals for the same fields, read back whichever format each
    wrote (the ASCII fallback prints 16 digits)."""
    rng = np.random.default_rng(2)
    for dim, C in ((2, 1), (3, 3)):
        jg, g = (mod.GridSpec(dim, 2, 2, C) for mod in (jax_grid, grid))
        cases = (("write_fine_grid_vtu",
                  {"u": rng.standard_normal((g.n_nodes, C))}),
                 ("write_coarse_grid_vtu",
                  {"c": rng.standard_normal(g.n_cells)}),
                 ("write_subcell_field_vtu",
                  {"s": rng.standard_normal(
                      int(np.prod(g.fine_cell_dims)))}))
        for fn, data in cases:
            a, b = tmp_path / f"a{dim}.vtu", tmp_path / f"b{dim}.vtu"
            getattr(io, fn)(str(a), g, data)
            getattr(jax_io, fn)(str(b), jg, data)
            ra, rb = read_vtu(a), read_vtu(b)
            assert list(ra) == list(rb), fn
            for key in rb:
                np.testing.assert_allclose(
                    ra[key].astype(np.float64), rb[key].astype(np.float64),
                    rtol=1e-15, atol=0)
