"""utils coverage: sweep manifests (resume/atomicity), GT I/O, profiling."""

import os

import numpy as np
import pytest

from aswstereomatch_tpu.utils import evaluate, io, manifest, profiling


def test_manifest_resume(tmp_path):
    path = str(tmp_path / "sweep.json")
    calls = []

    def work(pid):
        calls.append(pid)
        if pid == "c" and len(calls) <= 3:
            raise RuntimeError("simulated failure")
        return {"bad_2": 0.01}

    with pytest.raises(RuntimeError):
        manifest.run_sweep(["a", "b", "c", "d"], work, path, "cfg1")
    assert calls == ["a", "b", "c"]

    # resume: a/b are done, c retries, d runs
    results = manifest.run_sweep(["a", "b", "c", "d"], work, path, "cfg1")
    assert calls == ["a", "b", "c", "c", "d"]
    assert set(results) == {"a", "b", "c", "d"}

    # different config hash restarts from scratch
    m2 = manifest.SweepManifest(path, "cfg2")
    assert m2.pending(["a", "b"]) == ["a", "b"]


def test_gt_scaling(tmp_path):
    disp = np.array([[1.0, 2.5], [0.0, 4.0]], np.float32)
    p = str(tmp_path / "gt.pfm")
    io.write_pfm(p, disp * 256.0)
    got, valid = io.read_gt_disparity(p, "kitti")
    np.testing.assert_allclose(got, disp, atol=1e-5)
    assert valid.tolist() == [[True, True], [False, True]]
    with pytest.raises(KeyError):
        io.read_gt_disparity(p, "nonsense")


def test_pnm_16bit(tmp_path):
    arr = (np.arange(12) * 1000).astype(">u2").reshape(3, 4)
    p = str(tmp_path / "x.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n4 3\n65535\n" + arr.tobytes())
    img = io.read_pnm(p)
    assert img.shape == (3, 4)
    assert img.max() == 11000.0  # 16-bit samples stay raw

    from aswstereomatch_tpu.utils import native
    if native.available():
        np.testing.assert_array_equal(native.read_pnm(p), img)


def test_profiler_trace_smoke(tmp_path):
    import jax
    import jax.numpy as jnp

    d = str(tmp_path / "trace")
    with profiling.trace(d):
        with profiling.stage("cost"):
            x = jnp.ones((8, 8)) * 2
    jax.block_until_ready(x)
    assert os.path.isdir(d) and os.listdir(d)
    # no-op mode
    with profiling.trace(None):
        pass


def test_time_fn():
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda a: a * 2 + 1)
    best, mean, times = profiling.time_fn(f, jnp.ones((16, 16)), iters=3, warmup=1)
    assert 0 < best <= mean and len(times) == 3


def test_exact_match_and_delta():
    a = np.zeros((4, 4), np.float32)
    b = a.copy()
    b[0, 0] = 5.0
    assert evaluate.exact_match_rate(a, b) == 15 / 16
    assert evaluate.bad_delta_between(a, b, 2.0) == 1 / 16


def test_device_lock_exclusion_and_holder(tmp_path, monkeypatch):
    from aswstereomatch_tpu.utils import devlock

    monkeypatch.setenv("ASW_DEVICE_LOCK", str(tmp_path / "dev.lock"))
    with devlock.device_lock("first"):
        info = devlock.holder_info()
        assert info["pid"] == os.getpid() and info["label"] == "first"
        # flock is per-fd (not per-pid recursive): a second acquire in this
        # same process contends like another process would.
        with pytest.raises(TimeoutError, match="first"):
            with devlock.device_lock("second", timeout_s=0.2, poll_s=0.05):
                pass
    # released: immediate re-acquire succeeds, holder info goes stale-dead
    with devlock.device_lock("third", timeout_s=0):
        assert devlock.holder_info()["label"] == "third"


def test_device_lock_stale_holder_pid(tmp_path, monkeypatch):
    import json

    from aswstereomatch_tpu.utils import devlock

    lock = tmp_path / "dev.lock"
    monkeypatch.setenv("ASW_DEVICE_LOCK", str(lock))
    # A dead holder leaves contents but no flock: acquire must succeed
    # instantly and holder_info must report nobody.
    lock.write_text(json.dumps({"pid": 2 ** 22 + 1234, "label": "ghost"}))
    assert devlock.holder_info() is None
    with devlock.device_lock("taker", timeout_s=0):
        assert devlock.holder_info()["label"] == "taker"
