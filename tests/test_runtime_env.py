"""How the program meets its machine: the compile-cache location, refusing
a silent CPU fallback, the imports the CLI needs, the peak table, the
device-memory budgets and the native library build."""

import os
import subprocess
import sys
import threading

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=None, env_drop=(), cwd=REPO, timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


_PRINT_CACHE = (
    "import jax, tracs_tpu; print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_follows_env(tmp_path):
    cache = tmp_path / "jaxcache"
    r = _run(
        _PRINT_CACHE + "\nimport jax.numpy as jnp\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()",
        {"JAX_COMPILATION_CACHE_DIR": str(cache), "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_compile_cache_defaults_inside_checkout():
    r = _run(_PRINT_CACHE, {"JAX_PLATFORMS": "cpu"},
             env_drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == os.path.join(REPO, ".jax_cache")


def test_cli_refuses_cpu_fallback(tmp_path):
    """JAX_PLATFORMS=cuda on a machine without a GPU: JAX falls back to
    the appended cpu entry, and the CLI must exit non-zero before
    computing anything."""
    fa = tmp_path / "a.fasta"
    fa.write_text(">a\nACGT\n>b\nACGA\n")
    out = tmp_path / "out.csv"
    r = _run(["-m", "tracs_tpu", "distance", "--msa", str(fa), "-o", str(out)],
             {"JAX_PLATFORMS": "cuda"})
    assert r.returncode != 0
    assert "fell back to the CPU" in r.stderr
    assert not out.exists() or out.read_text().count("\n") <= 1


def test_cli_runs_on_cpu_when_asked(tmp_path):
    fa = tmp_path / "a.fasta"
    fa.write_text(">a\nACGT\n>b\nACGA\n")
    out = tmp_path / "out.csv"
    r = _run(["-m", "tracs_tpu", "distance", "--msa", str(fa), "-o", str(out)],
             {"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert out.read_text().splitlines()[1].startswith("a,b,NA,1,")


@pytest.mark.parametrize("command", ["distance", "cluster"])
def test_cli_help_without_optional_packages(command):
    """distance and cluster start with only the packages every install
    has: joblib, pandas and matplotlib are blocked from importing."""
    r = _run(
        "import sys\n"
        "for m in ('joblib', 'pandas', 'matplotlib'): sys.modules[m] = None\n"
        f"sys.argv = ['tracs-tpu', '{command}', '--help']\n"
        "import runpy; runpy.run_module('tracs_tpu', run_name='__main__')",
        {"JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr
    assert f"usage: tracs-tpu {command}" in r.stdout


def test_int8_peaks():
    import bench

    assert bench.int8_peak_ops("gpu", "NVIDIA H100 80GB HBM3") == 1979e12
    assert bench.int8_peak_ops("gpu", "NVIDIA H100 PCIe") == 1513e12
    assert bench.int8_peak_ops("cpu", "cpu") is None
    with pytest.raises(ValueError, match="no int8 peak"):
        bench.int8_peak_ops("gpu", "Some Other GPU")


def test_memory_budgets(monkeypatch):
    from tracs_tpu.runtime import memory

    for var in ("TRACS_TPU_DEVICE_SPLIT_BYTES", "TRACS_TPU_CHUNK_BYTES",
                "TRACS_TPU_DEVICE_HBM_BYTES", "TRACS_TPU_RING_BYTES"):
        monkeypatch.delenv(var, raising=False)
    # the test backend is the CPU, which reports no limit: the 16 GiB
    # values as they stand
    assert memory.device_bytes_limit() is None
    assert memory.memory_budgets() == memory.CPU_BUDGETS
    monkeypatch.setenv("TRACS_TPU_CHUNK_BYTES", "12345")
    assert memory.memory_budgets().chunk == 12345


def test_memory_budgets_follow_bytes_limit(monkeypatch):
    from tracs_tpu.runtime import memory

    for var in ("TRACS_TPU_DEVICE_SPLIT_BYTES", "TRACS_TPU_CHUNK_BYTES",
                "TRACS_TPU_DEVICE_HBM_BYTES", "TRACS_TPU_RING_BYTES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(memory, "device_bytes_limit", lambda: 60 << 30)
    # each budget keeps its share of 16 GiB
    b = memory.memory_budgets()
    assert b.device_split == 45 << 30
    assert b.chunk == (75 << 30) // 4
    assert b.device == (105 << 30) // 2
    assert b.ring_stripe == 15 << 30
    # the environment overrides still win
    monkeypatch.setenv("TRACS_TPU_CHUNK_BYTES", "12345")
    assert memory.memory_budgets().chunk == 12345
    assert memory.memory_budgets().ring_stripe == 15 << 30


@pytest.fixture
def native_src(tmp_path, monkeypatch):
    """runtime.native pointed at a private copy of the source."""
    import shutil

    from tracs_tpu.runtime import native

    src = tmp_path / "tracs_native.cpp"
    shutil.copy(os.path.join(REPO, "src", "tracs_native.cpp"), src)
    monkeypatch.setattr(native, "_SRC_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SRC_PATH", str(src))
    return native, src


def test_native_lib_path_follows_source(native_src):
    native, src = native_src
    before = native.lib_path()
    assert os.path.basename(before).startswith("libtracs_native-")
    src.write_text(src.read_text() + "\n// edited\n")
    assert native.lib_path() != before


def test_native_concurrent_builds(native_src):
    """Builders racing on one path each publish a complete library by
    rename; none sees a half-written file and no temporary is left."""
    import ctypes
    import shutil

    native, src = native_src
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    path = native.lib_path()
    results = []
    threads = [
        threading.Thread(target=lambda: results.append(native._build(path)))
        for _ in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert results == [True] * 4
    lib = ctypes.CDLL(path)
    assert hasattr(lib, "tn_fasta_pack")
    assert sorted(os.listdir(src.parent)) == sorted(
        ["tracs_native.cpp", os.path.basename(path)]
    )
