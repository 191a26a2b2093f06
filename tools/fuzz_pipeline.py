"""Extended randomized fuzz of the full pipeline across configs and
shardings (CPU, 8 virtual devices).

Per trial: random geometry + StereoConfig; checks
  1. jnp pipeline vs the NumPy loop oracle (subpixel-tolerance agreement),
  2. y-tiled == untiled bit-exact on a random tile count,
  3. batch-of-2 == single pair (every third trial),
  4. (ASW, D divisible by 4) d-sharded == unsharded bit-exact.

Complements the pinned 8-seed test-suite fuzz with an open-ended budget:
    python tools/fuzz_pipeline.py --trials 100 [--seed0 0]
Exit code 0 = no counterexample found.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--seed0", type=int, default=1000)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    import jax.numpy as jnp

    from aswstereomatch_tpu.config import StereoConfig
    from aswstereomatch_tpu.models import oracle_numpy, pipeline
    from aswstereomatch_tpu.parallel import dshard
    from aswstereomatch_tpu.parallel import mesh as mesh_lib
    from aswstereomatch_tpu.parallel import tiling
    from aswstereomatch_tpu.utils import synthetic

    def J(fn, **static):
        return jax.jit(functools.partial(fn, **static))

    failures = 0
    for t in range(args.trials):
        seed = args.seed0 + t
        rng = np.random.default_rng(seed)
        D = int(rng.choice([4, 8, 12, 16]))
        agg = str(rng.choice(["asw", "asw", "box"]))
        cfg = StereoConfig(
            max_disparity=D,
            window_radius=int(rng.choice([1, 2, 3, 4])),
            cost=str(rng.choice(["ad", "tad_grad"])),
            asw_symmetric=bool(rng.choice([True, False])),
            aggregation=agg,
            asw_separable=(
                agg == "asw" and bool(rng.choice([True, False, False]))
            ),
            gamma_color=float(rng.uniform(5, 30)),
            gamma_spatial=float(rng.uniform(5, 40)),
            alpha=float(rng.uniform(0.5, 1.0)),
            lr_check=bool(rng.choice([True, False])),
            fill_holes=True,
            subpixel=bool(rng.choice([True, False])),
            median_filter=bool(rng.choice([True, False])),
            median_mode=str(rng.choice(["plain", "weighted"])),
        )
        # small enough for the loop oracle
        h = int(rng.integers(12, 28))
        w = int(rng.integers(max(24, D + 8), 56))
        pair = synthetic.make_pair(height=h, width=w, max_disparity=D,
                                   seed=seed)
        l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
        t0 = time.time()
        label = (f"seed={seed} {h}x{w} D={D} r={cfg.window_radius} "
                 f"{cfg.aggregation}{'' if cfg.asw_symmetric else '/lo'}"
                 f"{'/sep' if cfg.asw_separable else ''} "
                 f"{cfg.cost} lr={cfg.lr_check} sub={cfg.subpixel} "
                 f"med={cfg.median_filter}/{cfg.median_mode}")
        try:
            d_jnp = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
            d_orc = oracle_numpy.match_pair(pair["left"], pair["right"], cfg)
            agree = np.mean(np.abs(d_jnp - d_orc) <= 0.51)
            assert agree > 0.98, f"jnp vs oracle agree {agree:.4%}"

            n = int(rng.choice([2, 4]))
            if h // n >= cfg.window_radius + 1:
                m = mesh_lib.build_mesh(data=1, tile=n)
                d_t = np.asarray(
                    J(tiling.match_pair_tiled, cfg=cfg, device_mesh=m)(l, r)
                )
                np.testing.assert_array_equal(d_t, d_jnp)

            if t % 3 == 0:  # batch API: batch-of-2 == single
                d_b = np.asarray(
                    J(pipeline.match_batch, cfg=cfg)(
                        jnp.stack([l, l]), jnp.stack([r, r])
                    )
                )
                np.testing.assert_array_equal(d_b[0], d_jnp)
                np.testing.assert_array_equal(d_b[1], d_jnp)

            if D % 4 == 0 and cfg.aggregation == "asw":
                m = mesh_lib.build_mesh(data=1, tile=4)
                d_d = np.asarray(
                    J(dshard.match_pair_dsharded, cfg=cfg, device_mesh=m)(l, r)
                )
                np.testing.assert_array_equal(d_d, d_jnp)
            print(f"[ok] {label} ({time.time()-t0:.1f}s)", flush=True)
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"[FAIL] {label}\n  {type(e).__name__}: {e}", flush=True)

    print(f"done: {args.trials} trials, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
