"""chip_smoke.py off the card: its guard refuses the CPU, and its phases
run end to end at a tiny size on the CPU test mesh."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_script_fails_without_gpu_or_checkout(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_expected_pairs_at_real_size():
    assert len(chip_smoke.expected_pairs(4096)) == 195 * 210 == 40_950
    assert len(chip_smoke.expected_pairs(1024)) == 48 * 210 + 120


def test_main_phase_tiny(tmp_path):
    chip_smoke.phase_main(str(tmp_path), 64, 4000, seed=0)


def test_filter_phase_tiny(tmp_path):
    chip_smoke.phase_filter(str(tmp_path), 48, 6000, seed=0, n_check=40)


def test_mesh_phase_tiny(tmp_path):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    chip_smoke.phase_mesh(str(tmp_path), 64, 4000, seed=0)
