"""Checks that the GPU entry points refuse to fall back to the CPU, and
that the compile cache and native build follow their environment."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR set: the package sets nothing and JAX's own
    reading of the variable stands. Unset: <checkout>/.jax_cache."""
    extra = {}
    if env_dir:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import json, jax; b = jax.config.jax_compilation_cache_dir; "
            "import spring_tpu; "
            "print(json.dumps([b, jax.config.jax_compilation_cache_dir]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=_clean_env(PYTHONPATH=str(REPO), **extra),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    before, after = json.loads(out.stdout.strip().splitlines()[-1])
    if env_dir:
        assert before == after == str(tmp_path / env_dir)
    else:
        assert before is None
        assert after == str(REPO / ".jax_cache")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_refuse_cpu(script):
    out = subprocess.run([sys.executable, str(REPO / script)],
                         cwd=str(REPO), env=_clean_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "GPU" in out.stdout + out.stderr
    assert '"ok"' not in out.stdout and '"metric"' not in out.stdout


def test_dryrun_multichip_raises_without_enough_devices():
    import jax
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as g
    assert len(jax.devices()) == 8            # conftest's virtual mesh
    with pytest.raises(RuntimeError, match="only 8"):
        g.dryrun_multichip(16)


def test_native_build_falls_back_to_an_openmp_compiler():
    """A CXX from the environment that cannot link OpenMP gives way to the
    system g++ (make -n: print the build command without running it)."""
    out = subprocess.run(
        ["make", "-n", "-B", "--no-print-directory", "-C",
         str(REPO / "spring_tpu" / "csrc"), "libspringtpu.so"],
        env=dict(os.environ, CXX="/nonexistent/g++"),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("g++ ")
    assert "/nonexistent" not in out.stdout
