"""PyTorch port: the ``benchmark_proj`` and ``benchmark`` CLIs against the
reference's ``examples/benchmark_proj.py`` and ``examples/benchmark.py``.

The reference scripts are loaded by path. The camera is the reference's
within 1e-7; the port draws its gaussians from a seeded ``torch.Generator``
(other numbers than ``jax.random``'s), so its data, as numpy, go through
both packages' projection (EWA and UT, at the projection tests'
tolerances) and binning, whose ``num_isects`` must equal what the port's
``run_pipeline`` reports. The result tables print the reference's text for
the same results. Timings are not compared: they are host times here.
"""

import dataclasses
import importlib.util
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu.ops.binning import bin_gaussians_to_tiles as jbin
from mojosplat_tpu.ops.projection import project_gaussians as jproject
from mojosplat_tpu_torch import RenderConfig
from mojosplat_tpu_torch.examples import benchmark, benchmark_proj
from mojosplat_tpu_torch.ops.binning import bin_gaussians_to_tiles
from mojosplat_tpu_torch.ops.projection import project_gaussians

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
# A small sweep point: the camera's fx = 80 puts the N(0, 2) cloud within
# about 40 pixels of the centre.
N, H, W = 3000, 64, 96
STAGES = ("projection", "binning", "rasterization", "e2e_forward", "e2e_fwd_bwd")


def load_reference(name: str):
    """examples/<name>.py of the reference package, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass resolves annotations there
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_proj():
    return load_reference("benchmark_proj")


def as_numpy(data):
    return [t.numpy() for t in data]


def test_create_camera_matches_reference(ref_proj):
    want = ref_proj.create_camera(H, W)
    got = benchmark_proj.create_camera(H, W, device="cpu")
    assert (got.H, got.W) == (H, W)
    for name in ("R", "T", "fx", "fy", "cx", "cy", "near", "far"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-7, err_msg=name)


def test_generate_gaussian_data_deterministic():
    a = benchmark_proj.generate_gaussian_data(500, device="cpu")
    b = benchmark_proj.generate_gaussian_data(500, device="cpu")
    c = benchmark_proj.generate_gaussian_data(500, seed=43, device="cpu")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and not torch.equal(x, z)
    means, log_scales, quats, opac = a
    assert means.shape == (500, 3) and log_scales.shape == (500, 3) and opac.shape == (500,)
    torch.testing.assert_close(torch.linalg.norm(quats, dim=-1), torch.ones(500))
    assert bool(((opac > 0) & (opac < 1)).all())
    assert abs(float(log_scales.mean()) + 3.0) < 0.02


@pytest.mark.parametrize("mode", ["ewa", "ut"])
def test_projection_of_the_data_matches_reference(ref_proj, mode):
    data = benchmark_proj.generate_gaussian_data(N, device="cpu")
    got = project_gaussians(*data, benchmark_proj.create_camera(H, W, device="cpu"),
                            RenderConfig(projection_mode=mode))
    want = jproject(*(jnp.asarray(x) for x in as_numpy(data)), ref_proj.create_camera(H, W),
                    JConfig(projection_mode=mode))
    for name in ("means2d", "conics", "depths", "compensations"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=name)
    radii, jradii = got.radii.numpy(), np.asarray(want.radii)
    if mode == "ewa":
        np.testing.assert_array_equal(radii, jradii)
    else:  # UT: at most a lane's rounding, by one pixel (the projection tests' rule)
        assert (radii != jradii).any(axis=1).sum() <= 1
        assert np.abs(radii - jradii).max() <= 1
    kept = (jradii > 0).all(axis=1)
    assert 0 < int(kept.sum()) < N


def test_num_isects_matches_reference_and_run_pipeline(ref_proj):
    data = benchmark_proj.generate_gaussian_data(N, device="cpu")
    jcfg = JConfig(tile_batch=512, raster_impl="xla")  # benchmark.py's, on the "xla" route
    jp = jproject(*(jnp.asarray(x) for x in as_numpy(data)), ref_proj.create_camera(H, W),
                  jcfg)
    want = int(jbin(jp.means2d, jp.radii, jp.depths, H, W, jcfg).aux.num_isects)
    cfg = RenderConfig(tile_batch=512, raster_impl="torch")
    tp = project_gaussians(*data, benchmark_proj.create_camera(H, W, device="cpu"), cfg)
    got = int(bin_gaussians_to_tiles(tp.means2d, tp.radii, tp.depths, H, W, cfg).aux.num_isects)
    assert got == want > 0
    # Timed elsewhere (test_benchmark_main_on_cpu): one untimed call a stage.
    def untimed(impl, name, fn, fn_args, iters):
        fn(*fn_args)
        return 0.0

    table = benchmark.main(CPU + ["--impls", "torch", "--gaussians", str(N), "--height", str(H),
                                  "--width", str(W)], time_stage=untimed)
    assert table[(N, "torch")]["num_isects"] == want


def sample_results(cls):
    return [cls("ewa", 1000, 0.5, 0.01, 0.49, 0.51), cls("ut", 1000, 0.9, 0.02, 0.88, 0.93),
            cls("ewa", 100000, 2.25, 0.1, 2.1, 2.4), cls("ut", 100000, 0.0, 0.0, 0.0, 0.0),
            cls("ewa", 7, 1e-4, 0.0, 1e-4, 1e-4)]


def test_tables_print_reference_text(ref_proj, capsys):
    ref_proj.print_results_table(sample_results(ref_proj.BenchmarkResult))
    ref_proj.speedup_analysis(sample_results(ref_proj.BenchmarkResult))
    want = capsys.readouterr().out
    benchmark_proj.print_results_table(sample_results(benchmark_proj.BenchmarkResult))
    benchmark_proj.speedup_analysis(sample_results(benchmark_proj.BenchmarkResult))
    got = capsys.readouterr().out
    assert got == want and "Speedup analysis" in got and "1000" in got


def test_benchmark_proj_main_on_cpu(tmp_path):
    plot = tmp_path / "proj.png"
    out = benchmark_proj.main(CPU + ["--gaussians", "200", "2000", "--height", str(H),
                                     "--width", str(W), "--iterations", "2",
                                     "--plot", str(plot)])
    res = out["results"]
    assert [(r.name, r.n_gaussians) for r in res] == [
        ("ewa", 200), ("ut", 200), ("ewa", 2000), ("ut", 2000)]
    for r in res:
        for f in dataclasses.fields(r)[2:]:
            assert math.isfinite(getattr(r, f.name)), (r, f.name)
        assert r.min_ms <= r.mean_ms <= r.max_ms and r.std_ms >= 0
    assert math.isfinite(out["throughput_scaling"])
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert not plot.exists()
    else:
        assert plot.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_benchmark_main_on_cpu(capsys):
    table = benchmark.main(CPU + ["--impls", "torch", "--gaussians", "300", "600", "--height",
                                  "32", "--width", "48", "--iterations", "2"])
    assert set(table) == {(300, "torch"), (600, "torch")}
    for r in table.values():
        assert set(r) == set(STAGES) | {"num_isects"}
        assert all(math.isfinite(r[k]) and r[k] >= 0 for k in STAGES)
        assert r["num_isects"] > 0
    out = capsys.readouterr().out
    assert "isects=" in out and "fwd+bwd ms" in out


def test_clis_refuse_cuda_off_the_card(monkeypatch):
    with pytest.raises(SystemExit):
        benchmark.main(CPU + ["--impls", "cuda"])
    with pytest.raises(SystemExit):
        benchmark.main(CPU + ["--impls", "torch", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        benchmark.main(["--impls", "torch"])
    with pytest.raises(SystemExit):
        benchmark_proj.main([])


@pytest.mark.parametrize("module", ["benchmark_proj", "benchmark"])
def test_module_imports_no_jax(module):
    code = (
        "import sys\n"
        f"import mojosplat_tpu_torch.examples.{module}\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'mojosplat_tpu' or m.startswith('mojosplat_tpu.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
