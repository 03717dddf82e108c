"""chip_smoke.py refuses to report anything without a GPU or a checkout,
and its main-path check reads the CLI's output."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(cwd, script):
    return subprocess.run([sys.executable, script], cwd=cwd,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"},
                          capture_output=True, text=True, timeout=300)


def _no_ok_line(stdout):
    return all('"ok"' not in line for line in stdout.splitlines())


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_fails_without_gpu_or_checkout(where, tmp_path):
    if where == "checkout":
        r = _run(REPO, SCRIPT)
    else:
        lone = tmp_path / "chip_smoke.py"
        shutil.copy(SCRIPT, lone)
        r = _run(tmp_path, str(lone))
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)


def test_gpu_phase_refuses_cpu_backend():
    """A phase child that finds no GPU exits non-zero, with no result."""
    r = subprocess.run([sys.executable, SCRIPT, "--phase", "fe", "float32"],
                       cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "PHASE_RESULT" not in r.stdout
    assert "no GPU" in r.stderr


def test_main_path_check_reads_cli_output():
    sys.path.insert(0, REPO)
    import chip_smoke

    good = "\n".join([
        "Device: gpu NVIDIA H100 80GB HBM3 x1",
        "Set-up: 60.0s (config, material prep, initial state)",
        "Compile: 30.0s",
    ] + [f"Timestep {k} at time 5e-07  residual 0.1 -> 0.2  flagged qps "
         f"{f}  md jobs {f}  reaction 1.5  (2.000s)"
         for k, f in ((1, 144), (2, 216), (3, 288))] + [
        "Max displacement: 0.00048 m",
        "Seconds per macro-step: 2.0 (mean of 3)",
        "Peak device memory: 123 bytes",
    ])
    assert chip_smoke._check_main_path(good) == []
    bad = (good.replace("Device: gpu", "Device: cpu")
           .replace("md jobs 216", "md jobs 200")
           .replace("reaction 1.5  (2.000s)\nMax", "reaction nan  (2.000s)\nMax"))
    problems = chip_smoke._check_main_path(bad)
    assert len(problems) == 3, problems
