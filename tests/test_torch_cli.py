"""The torch port's CLI, ``python -m origin_tpu_torch run | resume | status
| info``: the cases of tests/test_cli.py with ``--device cpu``, against
the JAX package's CLI run on the same cube (its power iteration run to its
whole budget, tests/jax_full_budget.py): the same Cat1 rows (x0, y0, z0,
profile, comp, ID) and Cat3 counts; ``--mesh 4 --device cpu`` against
the JAX CLI's ``--mesh 4``.  The default ``--device cuda`` raises
without a GPU (``--mesh N`` without N cards) before any session folder is
made.  ``--overlap-ingest`` is held in tests/test_torch_ingest.py."""

import os
import shutil

import numpy as np
import pytest
import torch

from jax_full_budget import jax_full_budget
from make_minicube import make_minicube
from origin_tpu.__main__ import main as jax_main
from origin_tpu.core import Table as JTable
from origin_tpu_torch.__main__ import main
from origin_tpu_torch.core import Table

torch.set_num_threads(2)

RUN = ["--purity", "0.8", "--minsize", "20", "--no-sources",
       "--loglevel", "WARNING"]


@pytest.fixture(scope="module")
def cube_fn(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli")
    fn = str(path / "minicube.fits")
    make_minicube(fn, nz=300, ny=40, nx=40)
    return fn


def _rows(folder, name, table=Table):
    cat = table.read(os.path.join(folder, name + ".fits"))
    cols = ("x0", "y0", "z0", "profile", "comp", "ID")
    return np.stack([np.asarray(cat[c], np.int64) for c in cols], axis=1)


def test_cli_run_and_status(cube_fn, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("ORIGIN_TPU_PRECISION", "unset")
    rc = main(["run", cube_fn, "--name", "clirun", "--path", str(tmp_path),
               *RUN, "--device", "cpu", "--precision", "highest"])
    assert rc == 0
    assert os.environ["ORIGIN_TPU_PRECISION"] == "highest"
    folder = str(tmp_path / "clirun")
    assert os.path.isfile(os.path.join(folder, "Cat3_lines.fits"))
    with jax_full_budget():
        assert jax_main(["run", cube_fn, "--name", "jaxrun", "--path",
                         str(tmp_path), *RUN]) == 0
    jax_folder = str(tmp_path / "jaxrun")
    rows = _rows(folder, "Cat1")
    assert len(rows) > 0
    np.testing.assert_array_equal(rows, _rows(jax_folder, "Cat1", JTable))
    for name in ("Cat3_lines", "Cat3_sources"):
        assert len(Table.read(os.path.join(folder, name + ".fits"))) == len(
            JTable.read(os.path.join(jax_folder, name + ".fits"))) > 0
    capsys.readouterr()

    assert main(["status", folder, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "- 09, clean_results: DUMPED" in out
    assert "- 10, create_masks: NOTRUN" in out
    assert main(["info", folder, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Step 09 - Results cleaning" in out and "finished" not in out


@pytest.mark.parametrize("cubes", ["two_fields", "bad_middle"])
def test_cli_survey_mode(cube_fn, tmp_path, capsys, cubes):
    """Several cubes in one invocation: per-cube sessions named by stem;
    a bad cube is reported (rc 1, its name on stderr) and does not stop
    the others."""
    second = str(tmp_path / "field2.fits")
    shutil.copy(cube_fn, second)
    order = [cube_fn, second]
    if cubes == "bad_middle":
        bad = str(tmp_path / "bad.fits")
        with open(bad, "wb") as fh:
            fh.write(b"not a FITS file")
        order.insert(1, bad)
    rc = main(["run", *order, "--name", "svy", "--path", str(tmp_path),
               *RUN, "--device", "cpu"])
    err = capsys.readouterr().err
    if cubes == "bad_middle":
        assert rc == 1 and "survey: 1 cube(s) failed: " + bad in err
    else:
        assert rc == 0 and "survey:" not in err
    cats = [_rows(str(tmp_path / f"svy-{stem}"), "Cat1")
            for stem in ("minicube", "field2")]
    np.testing.assert_array_equal(cats[0], cats[1])
    assert len(cats[0]) > 0


def test_cli_resume_noop(cube_fn, tmp_path):
    rc = main(["run", cube_fn, "--name", "cliresume", "--path",
               str(tmp_path), *RUN, "--device", "cpu"])
    assert rc == 0
    folder = str(tmp_path / "cliresume")
    cat1 = os.path.join(folder, "Cat1.fits")
    before = os.stat(cat1).st_mtime_ns, _rows(folder, "Cat1")
    # all catalog steps done -> resume runs nothing new and succeeds
    rc = main(["resume", folder, "--no-sources", "--loglevel", "WARNING",
               "--device", "cpu"])
    assert rc == 0
    assert os.stat(cat1).st_mtime_ns == before[0]
    np.testing.assert_array_equal(_rows(folder, "Cat1"), before[1])


def test_cli_mesh_matches_jax_mesh(tmp_path):
    """``--mesh 4 --device cpu`` row-shards the session over 4 CPU slots;
    its Cat1 rows equal the JAX CLI's ``--mesh 4`` on 4 of the virtual
    devices (48 rows: 12-row tiles hold the 25 x 25 FSF's halo)."""
    fn = str(tmp_path / "mesh.fits")
    make_minicube(fn, nz=300, ny=48, nx=48)
    argv = ["run", fn, "--path", str(tmp_path), *RUN, "--mesh", "4"]
    assert main([*argv, "--name", "port", "--device", "cpu"]) == 0
    with jax_full_budget():
        assert jax_main([*argv, "--name", "jax"]) == 0
    rows = _rows(str(tmp_path / "port"), "Cat1")
    assert len(rows) > 0
    np.testing.assert_array_equal(
        rows, _rows(str(tmp_path / "jax"), "Cat1", JTable))


def test_cli_mesh_needs_its_cards(cube_fn, tmp_path):
    """``--mesh N`` on the default ``--device cuda`` takes the first N
    cards and raises, before any folder is made, when torch sees fewer:
    it never puts the shards on one card or on the CPU by itself."""
    n = torch.cuda.device_count() + 1 if torch.cuda.is_available() else 2
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        main(["run", cube_fn, "--path", str(tmp_path), *RUN, "--mesh",
              str(n)])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("command", ["run", "survey", "resume", "status",
                                     "info"])
def test_cli_default_device_needs_a_gpu(cube_fn, tmp_path, command):
    """Without a GPU the default --device cuda raises before any folder
    is made (a survey too: it does not report each cube as failed)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda runs")
    argv = {
        "run": ["run", cube_fn, "--name", "gpu", *RUN],
        "survey": ["run", cube_fn, cube_fn, "--name", "gpu", *RUN],
        "resume": ["resume", str(tmp_path / "gpu")],
        "status": ["status", str(tmp_path / "gpu")],
        "info": ["info", str(tmp_path / "gpu")],
    }[command]
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv + ["--path", str(tmp_path)] * (command in ("run",
                                                             "survey")))
    assert os.listdir(tmp_path) == []
