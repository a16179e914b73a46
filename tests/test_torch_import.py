"""The torch port imports neither jax nor yaml, and its device is explicit."""

import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def test_port_runs_without_jax_or_yaml(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["yaml"] = None
        sys.path[:0] = [{REPO!r}, {TESTS!r}]
        import torch
        torch.set_num_threads(2)
        import origin_tpu_torch.pipeline.session as session
        import origin_tpu_torch.convert, origin_tpu_torch.ops.sweep
        import origin_tpu_torch.ops.build
        from make_minicube import make_minicube

        path = {str(tmp_path / "tiny.fits")!r}
        make_minicube(path, nz=40, ny=10, nx=12)
        orig = session.ORIGIN.init(path, device="cpu", path={str(tmp_path)!r},
                                   name="tiny", loglevel="WARNING")
        assert orig.engine.device.type == "cpu"
        assert orig.shape == (40, 10, 12)
        assert orig.engine.input_cube().device.type == "cpu"
        orig.close_logfile()
        if not torch.cuda.is_available():
            try:
                session.ORIGIN.init(path, device="cuda",
                                    path={str(tmp_path)!r}, name="gpu")
            except RuntimeError as exc:
                assert "cuda" in str(exc)
            else:
                raise AssertionError("device='cuda' did not raise")
        loaded = [m for m, v in sys.modules.items()
                  if v is not None and (m == "jax" or m.startswith("jax."))]
        assert not loaded, loaded
        print("PORT-OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT-OK" in res.stdout


def test_unported_entry_points_name_the_roadmap(tmp_path):
    import pytest

    from make_minicube import make_minicube
    from origin_tpu_torch.pipeline.session import ORIGIN

    path = str(tmp_path / "tiny.fits")
    make_minicube(path, nz=40, ny=10, nx=12)
    orig = ORIGIN.init(path, device="cpu", path=str(tmp_path), name="t",
                       loglevel="WARNING")
    for call in (orig.write, orig.step08_compute_spectra,
                 orig.step11_save_sources, lambda: ORIGIN.load("x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    assert [s.method_name for s in orig.steps.values()] == [
        "step01_preprocessing", "step02_areas",
        "step03_compute_PCA_threshold", "step04_compute_greedy_PCA",
        "step05_compute_TGLR", "step06_compute_purity_threshold",
        "step07_detection",
    ]
    orig.close_logfile()


def test_device_is_explicit():
    import pytest

    from origin_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
