"""bench.py harness behavior: a bench that finds no GPU fails.

It exits non-zero and prints no result line — never a number from another
device or an earlier run.  The test runs bench.py on the CPU backend in a
subprocess with a private device lock.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_fails_without_gpu(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["ASW_DEVICE_LOCK"] = str(tmp_path / "dev.lock")
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jax_cache")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode != 0, (out.stdout, out.stderr)
    # nothing on stdout: no result line, cached or otherwise
    assert out.stdout.strip() == "", out.stdout
    assert "no GPU" in out.stderr
