"""Run the five BASELINE.json configs and record bad-delta + pairs/s.

SURVEY.md section 4.5: dataset integration runs, one per BASELINE preset at
its real geometry, on synthetic layered scenes with exact ground truth (no
dataset files ship in this environment; utils/synthetic.py geometries mirror
Tsukuba / Venus-Teddy-Cones / KITTI).  Configs 4-5 prescribe multi-device
meshes; on a single GPU they run the same code path unsharded here, and
their sharded forms are validated bit-exact on virtual meshes by
tests/test_sharding.py — the note field records this.

Refuses to run without a GPU.  Writes bench_results/baseline_configs.json
(naming the card and its power limit) and prints a markdown table.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUNS = [
    # (preset, geometry, note)
    ("tsukuba_ad_box", "tsukuba", "config 1: AD + fixed window"),
    ("middlebury_asw", "venus", "config 2: TAD+grad, ASW 33x33"),
    ("middlebury_asw_full", "venus", "config 3: + LR/fill/subpixel/median"),
    ("middlebury_asw_full", "teddy", "config 3 on the teddy-class scene"),
    ("middlebury_asw_full", "cones", "config 3 on the cones-class scene"),
    ("kitti_tiled", "kitti",
     "config 4: tiled path validated on virtual mesh; timed unsharded here"),
    ("kitti_batch", "kitti",
     "config 5: batch/multi-host path validated via loopback test; "
     "timed single-pair here"),
]


def main():
    import jax
    import jax.numpy as jnp

    from aswstereomatch_tpu.config import get_preset
    from aswstereomatch_tpu.models.pipeline import StereoMatcher
    from aswstereomatch_tpu.utils import device, evaluate, synthetic

    device.require_gpu()
    card = device.card_line()
    rows = []
    for preset, geom, note in RUNS:
        cfg = get_preset(preset).replace(mesh_data=1, mesh_tile=1)
        pair = synthetic.make_dataset_pair(geom, seed=3)
        l = jnp.asarray(pair["left"])
        r = jnp.asarray(pair["right"])
        fn = StereoMatcher(cfg)
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(l, r))
        compile_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(l, r))
            times.append(time.perf_counter() - t0)
        # Queued throughput: submit Q dispatches back-to-back, wait once —
        # a sweep/serving pipeline keeps the device queue full.
        Q = 8
        t0 = time.perf_counter()
        jax.block_until_ready([fn(l, r) for _ in range(Q)])
        queued_s = (time.perf_counter() - t0) / Q
        disp = np.asarray(out)
        rep = evaluate.bad_report(disp, pair["gt"], valid=~pair["occluded"])
        rows.append(
            dict(
                preset=preset,
                geometry=geom,
                note=note,
                config_hash=cfg.config_hash(),
                pairs_per_s=round(1.0 / min(times), 4),
                pairs_per_s_queued=round(1.0 / queued_s, 4),
                compile_s=round(compile_s, 1),
                card=card,
                **{k: round(v, 5) for k, v in rep.items()},
            )
        )
        print(f"{preset}: {rows[-1]['pairs_per_s']} pairs/s "
              f"({rows[-1]['pairs_per_s_queued']} queued), "
              f"bad2={rows[-1]['bad_2']}", flush=True)

    os.makedirs("bench_results", exist_ok=True)
    with open("bench_results/baseline_configs.json", "w") as f:
        json.dump(rows, f, indent=2)

    print(f"\ncard: {card}")
    print("\n| preset | geometry | pairs/s | queued | bad-0.5 | bad-2.0 | EPE |")
    print("|---|---|---|---|---|---|---|")
    for r_ in rows:
        print(
            f"| {r_['preset']} | {r_['geometry']} | {r_['pairs_per_s']} | "
            f"{r_['pairs_per_s_queued']} | "
            f"{r_['bad_0.5']:.4f} | {r_['bad_2']:.4f} | {r_['epe']:.3f} |"
        )


if __name__ == "__main__":
    from aswstereomatch_tpu.utils import compile_cache, devlock

    compile_cache.enable()
    with devlock.device_lock("run_baseline_configs", timeout_s=120):
        main()
