"""CPU tests of the benchmark harness (``benchmark/``).

A tiny cell (300 x 40 x 40, a few sources) runs the whole harness on the
CPU, with the look for a chip skipped: set-up, the window, the check and
the last line.  Tests that need the card are marked ``gpu`` and skip
without one.  Run from the repository root:

    python -m pytest -q benchmark/tests
"""

import ast
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
sys.path.insert(0, ROOT)

from benchmark import field, run, spec  # noqa: E402

TINY = "tiny_field.tiny_mix"
BANNED = ("jax", "jaxlib", "flax", "origin_tpu")


def _tiny_root(tmp_path, minsize=100):
    """A checkout-like root: a copy of ``benchmark/`` and a BENCHMARK.json
    with one more cell made only of new files (a tiny configuration and
    mix; step 02's ``minsize`` 10 cuts its field into two areas)."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load(ROOT)
    conf = json.load(open(os.path.join(BENCH, "configs",
                                       "muse_wfm_dico3.json")))
    conf.update(name="tiny_field", shape=[300, 40, 40])
    dict(conf["survey"])["step02_areas"]["minsize"] = minsize
    (root / "benchmark" / "configs" / "tiny_field.json").write_text(
        json.dumps(conf))
    mix = json.load(open(os.path.join(BENCH, "traffic", "dense.json")))
    mix.update(n_cont=2, n_faint=6, n_bright=2)
    (root / "benchmark" / "traffic" / "tiny_mix.json").write_text(
        json.dumps(mix))
    bench["configs"].append(dict(bench["configs"][0], name="tiny_field",
                                 file="benchmark/configs/tiny_field.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=TINY,
                                   config="tiny_field", traffic="tiny_mix"))
    for metric in bench["per_layer"] + [
            m for m in bench["end_to_end"] if "workloads" in m]:
        metric["workloads"] = metric.get("workloads", []) + [TINY]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, trace=0, seed=3000000123, workload=TINY):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0", "--trace", str(trace)],
                      require_chip=False, device="cpu", root=str(root))
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


MOSAIC = "tiny_mosaic.tiny_mix"
# four fields, each with its own FSF (FWHM 0.64 + 0.04 f at the blue end,
# beta 2.6 + 0.1 f), on the four quadrants of a 40 x 40 field
MOSAIC_FIELDS = [dict(fwhm_pol=[-0.2, 0.64 + 0.04 * f], beta_pol=[2.6 + 0.1 * f])
                 for f in range(4)]
MOSAIC_MAP = [[0, 20, 0, 20], [0, 20, 20, 40], [20, 40, 0, 20],
              [20, 40, 20, 40]]


def _mosaic_config():
    conf, mix = _tiny_config()
    conf.update(name="tiny_mosaic", fields=MOSAIC_FIELDS,
                fieldmap=MOSAIC_MAP)
    return conf, mix


def _mosaic_root(tmp_path):
    """``_tiny_root`` with one more cell, a four-field mosaic, made only
    of new files: a configuration with ``fields`` and ``fieldmap`` and a
    ``workloads`` entry."""
    root = _tiny_root(tmp_path)
    conf, _ = _mosaic_config()
    (root / "benchmark" / "configs" / "tiny_mosaic.json").write_text(
        json.dumps(conf))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny_mosaic",
                                 file="benchmark/configs/tiny_mosaic.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=MOSAIC,
                                   config="tiny_mosaic", traffic="tiny_mix"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _tiny_config():
    conf = json.load(open(os.path.join(BENCH, "configs",
                                       "muse_wfm_dico3.json")))
    conf["shape"] = [300, 40, 40]
    mix = json.load(open(os.path.join(BENCH, "traffic", "dense.json")))
    mix.update(n_cont=2, n_faint=6, n_bright=2)
    return conf, mix


# -- the generator ------------------------------------------------------
def test_generator_same_seed_same_field_and_its_counts():
    conf, mix = _tiny_config()
    big = 2 ** 31 + 12345
    a, va, sa = field.make_field(conf, mix, big, "cpu")
    b, vb, sb = field.make_field(conf, mix, big, "cpu")
    c, _, sc = field.make_field(conf, mix, big + 1, "cpu")
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert torch.equal(torch.nan_to_num(va), torch.nan_to_num(vb))
    assert sa == sb
    assert not torch.equal(torch.nan_to_num(a), torch.nan_to_num(c))
    assert len(sa["lines"]) == len(sc["lines"]) == 8
    assert sum(k == "bright" for *_, k in sa["lines"]) == 2
    assert sa["n_cont"] == 2
    assert a.shape == (300, 40, 40) and a.dtype == torch.float32
    assert torch.isnan(a[:, 0, 0]).all() and torch.isnan(va[:, 0, 0]).all()
    assert int(torch.isnan(a).sum()) == 300


def test_field_file_reads_back_in_the_port(tmp_path):
    from benchmark import fitsfile
    from origin_tpu_torch.core import Cube

    conf, mix = _tiny_config()
    data, var, _ = field.make_field(conf, mix, 7, "cpu")
    path = str(tmp_path / "f.fits")
    fitsfile.write_cube(path, data, var, conf["geometry"], conf["fsf"])
    cube = Cube(path)
    assert torch.equal(torch.nan_to_num(torch.as_tensor(
        cube.data.filled(float("nan")) if hasattr(cube.data, "filled")
        else cube.data)), torch.nan_to_num(data))
    hdus = fitsfile.read_images(path)
    assert hdus[0][0]["FSF00F01"] == 0.7 and hdus[1][0]["EXTNAME"] == "DATA"
    assert torch.equal(torch.nan_to_num(torch.as_tensor(hdus[2][1])),
                       torch.nan_to_num(var))


# -- a mosaic: one FSF per field under a field map -------------------------
def test_a_mosaic_header_and_map_read_back_in_the_port(tmp_path):
    """The written header reads back in the port as one model per field
    with the configuration's polynomials, and the port's weights from the
    written field map equal the harness's."""
    import numpy as np

    from benchmark import fitsfile
    from origin_tpu_torch import fitsio
    from origin_tpu_torch.core.fsf import FieldsMap, read_fsf_from_header

    conf, mix = _mosaic_config()
    survey = run.Survey.__new__(run.Survey)
    survey.config, survey.device = conf, "cpu"
    survey.cube_path = str(tmp_path / "field.fits")
    survey.fieldmap = str(tmp_path / "fieldmap.fits")
    survey.write(mix, 17)
    models = read_fsf_from_header(fitsio.read(survey.cube_path)[0].header)
    assert [(m.fwhm_pol, m.beta_pol) for m in models] == [
        (f["fwhm_pol"], f["beta_pol"]) for f in MOSAIC_FIELDS]
    assert all(m.lbrange == tuple(conf["fsf"]["lbrange"]) for m in models)
    fmap = fitsfile.read_images(survey.fieldmap)[0][1]
    assert fmap.shape == (40, 40) and fmap[0, 0] == 1 and fmap[39, 39] == 4
    got = FieldsMap(survey.fieldmap, nfields=4).compute_weights()
    want = field.weight_maps(conf, "cpu").numpy()
    assert np.array_equal(np.stack(got), want)


def test_a_mosaic_line_takes_the_fsf_of_each_pixel_field():
    """A line across the quadrants' corner: each pixel of its stamp is the
    spot of the field that covers it; the draws are the single field's."""
    conf, mix = _mosaic_config()
    single, _ = _tiny_config()
    mix = dict(mix, n_cont=0, n_faint=0, n_bright=1, noise=1e-30,
               nan_spaxels=[])
    data, _, src = field.make_field(conf, mix, 4, "cpu")
    plain, _, src1 = field.make_field(single, mix, 4, "cpu")
    assert src == src1
    x0, y0, z0, _ = src["lines"][0]
    half = mix["spot_half"]
    stamp = data[z0, y0 - half:y0 + half + 1, x0 - half:x0 + half + 1]
    index = field.field_index(conf, "cpu")[y0 - half:y0 + half + 1,
                                            x0 - half:x0 + half + 1]
    lbda = field.wavelengths(conf, "cpu")
    for f, fsf in enumerate(field.fsf_models(conf)):
        spot = field.moffat_cube(lbda[z0:z0 + 1], fsf, 0.2, 2 * half + 1)[0]
        spot = spot / spot.max()
        on = index == f
        if bool(on.any()):
            ratio = stamp[on].double() / spot[on]
            assert float(ratio.max() - ratio.min()) < 1e-5 * float(ratio.max())
    assert not torch.equal(data, plain)


def test_one_field_paths_are_bit_identical_to_the_single_field():
    """With one FSF for every field the generator writes the single
    field's cube bit for bit; the reference's multi-field sums over one
    field with weight 1 give the single-field results bit for bit (lines
    away from the edge, where the weights read 0 outside the field)."""
    from benchmark import fitsfile
    from benchmark import reference as ref

    conf, mix = _tiny_config()
    same = dict(conf, fields=[dict(fwhm_pol=conf["fsf"]["fwhm_pol"],
                                   beta_pol=conf["fsf"]["beta_pol"])] * 2,
                fieldmap=[[0, 40, 0, 13], [0, 40, 13, 40]])
    a, va, _ = field.make_field(conf, mix, 99, "cpu")
    b, vb, _ = field.make_field(same, mix, 99, "cpu")
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert torch.equal(torch.nan_to_num(va), torch.nan_to_num(vb))
    assert (fitsfile.primary_cards(conf["fsf"], [conf["fsf"]])
            == fitsfile.primary_cards(conf["fsf"]))

    psf = field.moffat_cube(field.wavelengths(conf, "cpu"), conf["fsf"],
                            0.2, 25)
    ones = torch.ones((1, 40, 40), dtype=torch.float64)
    g = torch.Generator().manual_seed(1)
    faint = torch.randn((300, 40, 40), generator=g)
    mask = ~torch.isfinite(a)
    profiles = run.load_profiles(os.path.join(
        BENCH, "configs", "Dico_3FWHM.fits"))[0]
    for dt in (torch.float64, torch.float32):
        one = ref.glr(faint, mask, psf, profiles, dt)
        multi = ref.glr(faint, mask, psf[None], profiles, dt, weights=ones)
        assert all(torch.equal(x, y) for x, y in zip(one, multi))
        one = ref.deconvolved_lines(a, va, psf, [20, 14], [20, 25], dt)
        multi = ref.deconvolved_lines(a, va, psf[None], [20, 14], [20, 25],
                                      dt, weights=ones)
        assert all(torch.equal(x, y) for x, y in zip(one, multi))


def test_the_reference_spatial_filter_agrees_with_the_port_on_a_mosaic():
    """The reference's multi-field spatial stage against the port's
    ``glr_spatial`` on the CPU, both in float64 on the same FSF stack and
    weights.  Tolerance 1e-9 of the largest value: the two sides differ
    only in FFT sizes and summation order, float64 rounding of ~1e-14 per
    operation over a few thousand terms."""
    from benchmark import reference as ref
    from origin_tpu_torch.ops.convolve import fft2_shape
    from origin_tpu_torch.ops.glr import glr_spatial

    conf, _ = _mosaic_config()
    lbda = field.wavelengths(conf, "cpu")
    psfs = torch.stack([field.moffat_cube(lbda, fsf, 0.2, 25)
                        for fsf in field.fsf_models(conf)])
    weights = field.weight_maps(conf, "cpu")
    g = torch.Generator().manual_seed(2)
    cube = torch.randn((300, 40, 40), generator=g, dtype=torch.float64)
    want = ref.spatial_filter(cube, psfs, torch.float64, weights=weights)
    got = glr_spatial(cube, psfs, weights, fft2_shape((40, 40), (25, 25)))
    for w, gt in zip(want, got):
        scale = float(w.abs().max())
        assert float((w - gt).abs().max()) <= 1e-9 * scale
    plain = ref.spatial_filter(cube, psfs[0], torch.float64)
    assert float((plain[0] - want[0]).abs().max()) > 1e-3 * float(
        want[0].abs().max())


def test_a_mosaic_cell_of_new_files_runs_correct(tmp_path):
    root = _mosaic_root(tmp_path)
    rc, line = _run(root, workload=MOSAIC)
    assert rc == 0
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == 1


@pytest.mark.parametrize("stage,at,numbers", [
    ("spatial_filter", 1, ("correl_gap",)),
    ("deconvolved_lines", 2, ("flux_gap", "line_gap", "line_pos_differ")),
])
def test_a_reference_without_one_field_fsf_is_not_correct(
        tmp_path, monkeypatch, stage, at, numbers):
    """The reference's mosaic sum (step 05's spatial stage, or step 08's
    window FSF) with the last field's FSF dropped: the tiny mosaic cell
    comes out not correct, on that stage's numbers."""
    from benchmark import reference as ref

    plain = getattr(ref, stage)

    def dropped(*args, weights=None, **kwargs):
        if weights is not None:
            args = list(args)
            args[at], weights = args[at][:-1], weights[:-1]
        return plain(*args, weights=weights, **kwargs)

    monkeypatch.setattr(ref, stage, dropped)
    root = _mosaic_root(tmp_path)
    rc, line = _run(root, workload=MOSAIC)
    assert rc == 0
    assert line["correct"] is False
    assert any(line["checks"][n]["value"] > line["checks"][n]["limit"]
               for n in numbers), line["checks"]


# -- BENCHMARK.json and its files ----------------------------------------
def test_every_workload_resolves_to_its_files():
    bench = spec.load(ROOT)
    for cell in bench["workloads"]:
        got, conf, mix, e2e, per_layer = spec.resolve(bench, cell["name"],
                                                      ROOT)
        assert got is cell
        assert conf["name"] == cell["config"]
        assert {m["name"] for m in e2e} >= {"setup_s", "field_s"}
        assert per_layer, cell["name"]
        for m in per_layer:
            assert os.path.exists(os.path.join(BENCH, "readers",
                                               m["reader"] + ".py"))
            if "work" in m:
                assert os.path.exists(os.path.join(BENCH, "work",
                                                   m["work"] + ".py"))
            assert m["moves"] in {e["name"] for e in e2e}
    for conf in bench["configs"]:
        assert conf["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, conf["file"]))


def test_a_cell_made_of_new_files_is_found(tmp_path):
    root = _tiny_root(tmp_path)
    (root / "benchmark" / "metrics" / "front_s.json").write_text(json.dumps(
        dict(reader="span", spans=["step01", "step02"], unit="s",
             moves="field_s")))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(name="front_s", unit="s", better="lower",
                                   source="program_span", layer="front",
                                   moves="field_s", workloads=[TINY]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, conf, mix, e2e, per_layer = spec.resolve(
        spec.load(str(root)), TINY, str(root), str(root / "benchmark"))
    assert conf["shape"] == [300, 40, 40] and mix["n_faint"] == 6
    assert "front_s" in {m["name"] for m in per_layer}
    other = spec.resolve(spec.load(str(root)), "muse_wfm_dico3.dense",
                         str(root), str(root / "benchmark"))
    assert "front_s" not in {m["name"] for m in other[4]}


def test_names_units_and_entries_keep_the_contract():
    bench = spec.load(ROOT)
    assert spec.bad_names(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    text = re.compile(r"^[^\n\t]{1,200}$")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text.match(c["why"]) and text.match(c["source"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert text.match(w["why"]) and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert text.match(m["layer"])
    assert 1 <= bench["run_seconds"] <= 51
    words = bench["command"]
    assert all(text.match(w) and not w.startswith("/") and ".." not in w
               for w in words)


# -- a run, on the CPU ---------------------------------------------------
def test_a_run_prints_the_contract_line(tmp_path):
    root = _tiny_root(tmp_path)
    rc, line = _run(root)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"field_s", "peak_mem_gib", "setup_s"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert not os.path.exists(root / "build" / "benchmark" / TINY)


def test_a_traced_run_reports_the_span_metrics(tmp_path):
    root = _tiny_root(tmp_path)
    rc, line = _run(root, trace=1)
    assert rc == 0 and line["correct"] is True
    spans = {m["name"] for m in spec.load(ROOT)["per_layer"]
             if json.load(open(os.path.join(
                 BENCH, "metrics", m["name"] + ".json")))["reader"] == "span"}
    assert set(line["metrics"]) == spans
    assert all(m["value"] > 0 for m in line["metrics"].values())


def test_no_chip_no_result(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    root = _tiny_root(tmp_path)
    rc = run.main(["--workload", TINY, "--seed", "1", "--seconds", "1"],
                  root=str(root))
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_bare_checkout_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, the
    port is missing: the command exits non-zero and prints no result."""
    root = tmp_path / "bare"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "muse_wfm_dico3.dense", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# -- what the harness and the reference import ----------------------------
def test_banned_modules_are_matched_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "origin_tpu_torch_fake", object())
    assert "origin_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "origin_tpu.fake", object())
    assert run.banned_modules() == ["origin_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        if "tests" in dirpath.split(os.sep):
            continue
        yield from (os.path.join(dirpath, f) for f in files
                    if f.endswith(".py"))


def test_no_harness_module_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in BANNED, (path, name)


def test_a_run_loads_no_jax_in_its_process(tmp_path):
    root = _tiny_root(tmp_path)
    code = (
        "import sys, io, contextlib\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in BANNED)
        + "from benchmark import run\n"
        "rc = run.main(['--workload', %r, '--seed', '5', '--seconds', '0'],"
        " require_chip=False, device='cpu', root=%r)\n"
        "for m in %r: sys.modules.pop(m)\n"
        "sys.exit(rc or bool(run.banned_modules()))\n"
        % (TINY, str(root), BANNED))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_the_reference_imports_nothing_of_the_port():
    plain = ("reference", "check", "field", "fitsfile", "peaks",
             "work.toeplitz_sweep")
    for name in plain:
        for imp in _imports(os.path.join(BENCH, *name.split(".")) + ".py"):
            assert imp.split(".")[0] not in BANNED + ("origin_tpu_torch",)
    code = (f"import sys\nsys.path.insert(0, {ROOT!r})\n"
            "sys.modules['origin_tpu_torch'] = None\n"
            + "".join(f"import benchmark.{n}\n" for n in plain)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('origin_tpu_torch', 'origin_tpu', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['origin_tpu_torch']"


# -- the check: the timed path broken underneath --------------------------
def _state_unchanged(monkeypatch):
    """Step 04 returns its state unchanged: no nuisance is removed."""
    import numpy as np

    from origin_tpu_torch.pipeline import engine

    def unchanged(flat, areamap, *args, **kwargs):
        return np.zeros(np.shape(areamap), np.int32), 0, []

    monkeypatch.setattr(engine, "greedy_pca_areas", unchanged)


def _o2_threshold_altered(monkeypatch):
    """Step 03's thresholds come out altered by 0.01."""
    from origin_tpu_torch.pipeline import steps

    plain = steps.compute_thresh_gaussfit

    def altered(*args, **kwargs):
        hist, bins, thres, mea, std = plain(*args, **kwargs)
        return hist, bins, thres + 0.01, mea, std

    monkeypatch.setattr(steps, "compute_thresh_gaussfit", altered)


def _all_areas_but_one(monkeypatch):
    """Step 04 leaves every area but the first as it was."""
    import numpy as np

    from origin_tpu_torch.pipeline import engine

    plain = engine.greedy_pca_areas

    def broken(flat, areamap, *args, **kwargs):
        before = flat.clone()
        out = plain(flat, areamap, *args, **kwargs)
        other = torch.as_tensor((np.asarray(areamap) > 1).ravel())
        assert bool(other.any())
        flat[:, other.to(flat.device)] = before[:, other.to(flat.device)]
        return out

    monkeypatch.setattr(engine, "greedy_pca_areas", broken)


def _half_left_out(monkeypatch):
    """Step 01 takes each channel's background level over half of the
    spaxels, leaving the other half out."""
    from origin_tpu_torch.pipeline import engine

    plain = engine.standardize

    def half(cube, cont, var, mask, with_mean=False, mean_z=None):
        ny = cube.shape[1] // 2
        good = ~mask[:, :ny]
        part = torch.where(good, (cube - cont)[:, :ny], 0.0)
        mean_z = part.sum(dim=(1, 2)) / good.sum(dim=(1, 2)).clamp(min=1)
        return plain(cube, cont, var, mask, with_mean=with_mean,
                     mean_z=mean_z)

    monkeypatch.setattr(engine, "standardize", half)


def _answer_altered(monkeypatch):
    """Step 06's correl threshold comes out altered by 0.01."""
    from origin_tpu_torch.pipeline import steps

    plain = steps.compute_threshold_purity_pair

    def altered(*args, **kwargs):
        t, pval, t_std, pval_comp = plain(*args, **kwargs)
        return t + 0.01, pval, t_std, pval_comp

    monkeypatch.setattr(steps, "compute_threshold_purity_pair", altered)


def _row_altered(monkeypatch):
    """Step 07 drops one correl detection where it is produced."""
    from origin_tpu_torch.pipeline.engine import TorchEngine

    plain = TorchEngine.detections_above

    def dropped(self, name, threshold, gather=()):
        (z, y, x), vals, extra = plain(self, name, threshold, gather)
        if name == "cube_local_max" and len(z):
            return (z[1:], y[1:], x[1:]), vals[1:], [e[1:] for e in extra]
        return (z, y, x), vals, extra

    monkeypatch.setattr(TorchEngine, "detections_above", dropped)


def _group_altered(monkeypatch):
    """Step 07's merging moves the last line into the first group."""
    from origin_tpu_torch.pipeline import steps

    plain = steps.spatiospectral_merging

    def moved(*args, **kwargs):
        out = plain(*args, **kwargs)
        ids = out["imatch"]
        ids[len(out) - 1] = ids[0]
        out["imatch"] = ids
        return out

    monkeypatch.setattr(steps, "spatiospectral_merging", moved)


def _line_estimate_altered(key, change):
    def fault(monkeypatch):
        from origin_tpu_torch.pipeline import steps

        plain = steps.estimation_line_arrays

        def altered(*args, **kwargs):
            out = plain(*args, **kwargs)
            out[key][0] = change(out[key][0])
            return out

        monkeypatch.setattr(steps, "estimation_line_arrays", altered)

    fault.__doc__ = f"Step 08's first {key} comes out altered."
    return fault


def _merge_altered(monkeypatch):
    """Step 09 marks the first line as merged into the second."""
    from origin_tpu_torch.pipeline import steps

    plain = steps.merge_similar_lines

    def altered(*args, **kwargs):
        out = plain(*args, **kwargs)
        merged = out["merged_in"]
        merged[0] = out["num_line"][1]
        out["merged_in"] = merged
        return out

    monkeypatch.setattr(steps, "merge_similar_lines", altered)


def _mask_pixel_altered(monkeypatch):
    """Step 10 flips one pixel of each sky mask where it is written."""
    from origin_tpu_torch.artifacts import masks

    plain = masks._trim_masks

    def altered(*args, **kwargs):
        src, sky, *rest = plain(*args, **kwargs)
        sky = sky.copy()
        sky[0, 0] = 1 - sky[0, 0]
        return (src, sky, *rest)

    monkeypatch.setattr(masks, "_trim_masks", altered)


@pytest.mark.parametrize("fault,number,minsize", [
    (_state_unchanged, "faint_gap_median_area", 100),
    (_state_unchanged, "pca_first_u_gap", 100),
    (_o2_threshold_altered, "o2_threshold_differ", 100),
    (_all_areas_but_one, "faint_gap_median_area", 10),
    (_half_left_out, "std_gap", 100),
    (_answer_altered, "threshold_gap", 100),
    (_row_altered, "cat0_differ", 100),
    (_group_altered, "cat1_differ", 100),
    (_line_estimate_altered("flux", lambda f: f * 1.01), "flux_gap", 100),
    (_line_estimate_altered("line", lambda v: v * 1.01), "line_gap", 100),
    (_line_estimate_altered("z", lambda z: z + 1), "line_pos_differ", 100),
    (_merge_altered, "cat3_differ", 100),
    (_mask_pixel_altered, "masks_differ", 100),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault,
                                            number, minsize):
    root = _tiny_root(tmp_path, minsize)
    fault(monkeypatch)
    rc, line = _run(root)
    assert rc == 0
    assert line["correct"] is False
    c = line["checks"][number]
    assert c["value"] > c["limit"], line["checks"]


# -- on the card ----------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_the_control_fails_a_limit_on_the_card(card, tmp_path):
    """The reference in TF32 in the program's place, on a 3681 x 60 x 60
    cut of the field's configuration, fails a limit that the program
    meets."""
    from benchmark import control

    root = _tiny_root(tmp_path)
    conf = json.loads((root / "benchmark" / "configs" / "tiny_field.json")
                      .read_text())
    conf["shape"] = [3681, 60, 60]
    (root / "benchmark" / "configs" / "tiny_field.json").write_text(
        json.dumps(conf))
    rows = control.main(["--workload", TINY, "--seeds", "11,12"],
                        root=str(root))
    for row in rows:
        assert row["program_correct"] is True, row
        assert row["control_correct"] is False, row
