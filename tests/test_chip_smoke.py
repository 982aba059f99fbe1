"""chip_smoke.py and the helpers around it, on the CPU: each phase at a
tiny size (the XLA path: the kernel needs a card), the refusal to run
without a GPU, the compile-cache helper, the peaks table and the sample
CLI's platform choice."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("phase, kw", [
    (chip_smoke.phase_sample, dict(modes=("dense", "sparse"), reps=1)),
    (chip_smoke.phase_batched, dict(batch=64, reps=1)),
    (chip_smoke.phase_pinhole, dict(ncam=4, npts=200, reps=1)),
    (chip_smoke.phase_grid, dict(width=8, height=8, b=2, amalgamate=4,
                                 reps=1)),
    (chip_smoke.phase_midsize, dict(nstate=20, batch=8, reps=1)),
])
def test_phase_passes_its_gate_at_tiny_size(phase, kw):
    res = phase(**kw)
    assert res["gate_ok"], res
    assert res.get("warm_s", 0.0) >= 0.0
    json.dumps(res)     # one JSON line per phase


def test_batched_phase_reports_path_and_agreement():
    res = chip_smoke.phase_batched(batch=64, reps=1)
    assert res["path"] == "xla"          # no kernel on the CPU backend
    assert 0.0 <= res["f64_decision_agreement"] <= 1.0
    assert res["recovered_frac"] >= 0.99


def test_mesh_phases_on_virtual_devices():
    """The four-card phases, rehearsed on 4 of the 8 virtual CPU devices."""
    dp = chip_smoke.phase_dp4(batch=64)
    assert dp["gate_ok"] and dp["step_count_identical"]
    meas = chip_smoke.phase_meas4()
    assert meas["gate_ok"], meas


def test_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 3
    out = capsys.readouterr()
    assert "needs a GPU" in out.err
    assert '"ok"' not in out.out


def _run_alone(tmp_path, env_extra=None):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_script_alone_fails_and_prints_no_result(tmp_path):
    out = _run_alone(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_compile_cache_follows_the_environment(tmp_path):
    code = ("import jax; from libdogleg_tpu.utils.compile_cache import "
            "enable_compile_cache as e; d = e(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == [str(tmp_path), str(tmp_path)]
    env.pop("JAX_COMPILATION_CACHE_DIR")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == [os.path.join(REPO, ".jax_cache")] * 2


def test_peaks_lookup_raises_for_an_unknown_device():
    code = ("import bench_kernels as b\n"
            "assert 'NVIDIA H100 80GB HBM3' in b.PEAKS\n"
            "try:\n    b.peaks()\nexcept KeyError as e:\n"
            "    print('raised', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert "raised" in out.stdout and "'cpu'" in out.stdout


@pytest.mark.parametrize("card, watts, below", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 700.0, False),
    ("NVIDIA H100 80GB HBM3, 400.00 W", 400.0, True),
])
def test_kernel_lines_carry_the_power_limit(card, watts, below):
    """A card set below the power its peaks assume is flagged on every
    bench_kernels line."""
    code = ("import bench_kernels as b\n"
            f"b.CARD = {card!r}\n"
            "b.peaks = lambda: b.PEAKS['NVIDIA H100 80GB HBM3']\n"
            "b.emit('k', 1.0, 'u')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["power_limit_w"] == watts
    assert line["below_peaks_power"] is below


def test_sample_cli_platform_choices():
    from libdogleg_tpu.sample import build_parser
    ap = build_parser()
    assert ap.parse_args(["--platform", "gpu", "dense"]).platform == "gpu"
    assert ap.parse_args(["--platform", "cpu", "dense"]).platform == "cpu"
    with pytest.raises(SystemExit):
        ap.parse_args(["--platform", "tpu", "dense"])
