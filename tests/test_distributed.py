"""Multi-process (loopback DCN) test of the distributed batch path.

SURVEY.md section 4.4: ``jax.distributed.initialize`` with 2 local processes
over loopback on the CPU backend — the same code path a real multi-host
deployment uses for the data axis.  Each process owns 4 of 8 global devices; the batch
shards over (data=2-hosts-equivalent, tile) and results must match the
single-process pipeline exactly.

Runs as subprocesses so the main pytest process keeps its own runtime.
"""

import os
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    pid = int(sys.argv[1])
    jax.distributed.initialize(
        coordinator_address="127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    import numpy as np
    import jax.numpy as jnp
    from aswstereomatch_tpu.config import StereoConfig
    from aswstereomatch_tpu.parallel import distributed, mesh as mesh_lib
    from aswstereomatch_tpu.utils import synthetic

    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()

    cfg = StereoConfig(
        max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
        lr_check=True, fill_holes=True, subpixel=True, median_filter=True,
    )
    # batch >= 16 pairs, per BASELINE config 5
    pairs = [synthetic.make_pair(height=32, width=48, max_disparity=8, seed=s)
             for s in range(16)]
    lefts = np.stack([p["left"] for p in pairs])
    rights = np.stack([p["right"] for p in pairs])

    m = distributed.global_mesh(tile=4)  # data=2 across processes
    out = distributed.run_batch_distributed(lefts, rights, cfg, m)
    out_local = [np.asarray(s.data) for s in out.addressable_shards]

    # Cross-process collectives for the other layouts too: x-tiling (D_max
    # halo ppermute) and disparity sharding (all_gather combine) on the
    # 8-device global mesh spanning both processes.
    import functools
    from aswstereomatch_tpu.models import pipeline
    from aswstereomatch_tpu.parallel import dshard, tiling
    fn = jax.jit(functools.partial(pipeline.match_pair, cfg=cfg))

    l0 = jnp.asarray(lefts[0])
    r0 = jnp.asarray(rights[0])
    ref0 = np.asarray(fn(l0, r0))
    def assert_shards_match(global_arr, ref, expect_local):
        # global arrays spanning both processes are not fully addressable;
        # check the local shards against the matching slices of the local
        # reference
        checked = 0
        for s in global_arr.addressable_shards:
            np.testing.assert_array_equal(np.asarray(s.data), ref[s.index])
            checked += 1
        assert checked > 0 or not expect_local

    def has_local(m):
        return any(d.process_index == jax.process_index()
                   for d in m.devices.flat)

    mt4 = mesh_lib.build_mesh(data=1, tile=4)  # 12 cols/shard >= halo 9
    out_x = jax.jit(functools.partial(
        tiling.match_pair_tiled_x, cfg=cfg, device_mesh=mt4))(l0, r0)
    assert_shards_match(out_x, ref0, has_local(mt4))
    mt8 = mesh_lib.build_mesh(data=1, tile=8)  # spans both processes
    out_d = jax.jit(functools.partial(
        dshard.match_pair_dsharded, cfg=cfg, device_mesh=mt8))(l0, r0)
    assert_shards_match(out_d, ref0, has_local(mt8))

    # Check this process's addressable shards of the global result against
    # the single-device unsharded reference, pair by pair.
    for s in out.addressable_shards:
        b0 = s.index[0].start or 0
        rows = s.index[1]
        for bi in range(s.data.shape[0]):
            ref = np.asarray(fn(jnp.asarray(lefts[b0 + bi]),
                                jnp.asarray(rights[b0 + bi])))
            got = np.asarray(s.data[bi])
            r0 = rows.start or 0
            np.testing.assert_array_equal(got, ref[r0 : r0 + got.shape[0]])
    print(f"proc {pid} OK")
    """
)


def _run_cluster(tmp_path, worker_src: str, n_procs: int, timeout=600):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(worker_src.replace("{port}", str(port)))
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=repo_root,
        )
        for i in range(n_procs)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out


@pytest.mark.slow
def test_two_process_loopback(tmp_path):
    _run_cluster(tmp_path, _WORKER, 2)


# 4-process cluster, ONE device per process: the (data=2, tile=2) mesh puts
# every mesh edge across a process boundary, so the y-tile halo ppermute,
# the batch shard/gather, the x-tile D_max strip exchange and the d-shard
# combine all ride the loopback DCN — none can fall back to intra-process
# transfers (round-5 verdict task 5; SURVEY.md section 4.4).
_WORKER4 = textwrap.dedent(
    """
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    pid = int(sys.argv[1])
    jax.distributed.initialize(
        coordinator_address="127.0.0.1:{port}",
        num_processes=4,
        process_id=pid,
    )
    import functools
    import numpy as np
    import jax.numpy as jnp
    from aswstereomatch_tpu.config import StereoConfig
    from aswstereomatch_tpu.models import pipeline
    from aswstereomatch_tpu.parallel import distributed, dshard
    from aswstereomatch_tpu.parallel import mesh as mesh_lib, tiling
    from aswstereomatch_tpu.utils import synthetic

    assert jax.process_count() == 4, jax.process_count()
    assert jax.device_count() == 4, jax.device_count()
    assert jax.local_device_count() == 1

    cfg = StereoConfig(
        max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
        lr_check=True, fill_holes=True, subpixel=True, median_filter=True,
    )
    pairs = [synthetic.make_pair(height=32, width=48, max_disparity=8, seed=s)
             for s in range(8)]
    lefts = np.stack([p["left"] for p in pairs])
    rights = np.stack([p["right"] for p in pairs])

    # data=2 x tile=2 spanning all four processes: batch + y-tile composed
    m = distributed.global_mesh(tile=2)
    assert m.devices.shape == (2, 2)
    procs_in_mesh = {d.process_index for d in m.devices.flat}
    assert len(procs_in_mesh) == 4, procs_in_mesh
    out = distributed.run_batch_distributed(lefts, rights, cfg, m)

    fn = jax.jit(functools.partial(pipeline.match_pair, cfg=cfg))
    for s in out.addressable_shards:
        b0 = s.index[0].start or 0
        rows = s.index[1]
        for bi in range(s.data.shape[0]):
            ref = np.asarray(fn(jnp.asarray(lefts[b0 + bi]),
                                jnp.asarray(rights[b0 + bi])))
            got = np.asarray(s.data[bi])
            r0 = rows.start or 0
            np.testing.assert_array_equal(got, ref[r0 : r0 + got.shape[0]])

    # x-tiling and d-sharding over all 4 single-device processes: every
    # ppermute / gather hop crosses a process boundary.
    l0, r0_ = jnp.asarray(lefts[0]), jnp.asarray(rights[0])
    ref0 = np.asarray(fn(l0, r0_))
    mt4 = mesh_lib.build_mesh(data=1, tile=4)  # 12 cols/shard >= halo 9
    out_x = jax.jit(functools.partial(
        tiling.match_pair_tiled_x, cfg=cfg, device_mesh=mt4))(l0, r0_)
    for s in out_x.addressable_shards:
        np.testing.assert_array_equal(np.asarray(s.data), ref0[s.index])
    out_d = jax.jit(functools.partial(
        dshard.match_pair_dsharded, cfg=cfg, device_mesh=mt4))(l0, r0_)
    for s in out_d.addressable_shards:
        np.testing.assert_array_equal(np.asarray(s.data), ref0[s.index])
    print(f"proc {pid} OK")
    """
)


@pytest.mark.slow
def test_four_process_loopback(tmp_path):
    _run_cluster(tmp_path, _WORKER4, 4)
