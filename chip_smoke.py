"""On-card smoke test: the stereo pipeline's main path, end to end, on a GPU.

One process, one card, the normal entry points:

  device      JAX's default device must be a GPU; prints the card's
              ``nvidia-smi`` name and power limit.
  library     ``StereoMatcher.from_preset(name)`` single pair and ``.batch``
              (B=2) at each preset's real geometry (KITTI 1242x375 D=128,
              Middlebury 450x375 D=64, Tsukuba 384x288 D=16) on seeded
              synthetic scenes with exact ground truth: bad-2.0 < 5% on
              non-occluded pixels, density 1.0, values in [0, D), batch ==
              single within 1e-4 px on >= 99.99% of pixels.
  hard_pins   the hard-scene accuracy pins (config.HARD_PINS) on the card.
  oracle      each preset's flags on a 48x64 crop (D=16, r=4): the card's
              jitted pipeline vs the NumPy loop oracle — integer WTA
              identical on >= 99.9% of pixels, disparity within 1e-4 px
              wherever WTA agrees.
  cli         ``cli.main`` in-process on a synthetic KITTI pair.
  server      ``tools/serve.py``'s ``Server`` on a thread of this process:
              a float32 request, a uint8 request with the uint16_x256
              response, and a confidence request.

``--four-cards`` runs only the device check and the sharded layouts on four
cards (y-tiles, x-tiles, d-shards, and the 2x2 data x tile batch of four
pairs, all at KITTI geometry with the ``kitti_sep`` preset — separable
symmetric ASW, whose programs compile in seconds) against single-card runs
on device 0 in the same process.

Precision: float32 throughout.  The pipeline has no matrix product (the
Lab conversion is written as explicit multiply-adds, the sRGB decode is a
table gather), so TF32 tensor-core rounding cannot enter.

Compiled programs go to JAX's persistent compilation cache
(``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``), so a
second run in the same checkout loads instead of compiling.

Any failed phase makes the script exit non-zero without the result line.
The last line of a passing run is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Usage:
  python chip_smoke.py                  # one GPU, full geometry
  python chip_smoke.py --four-cards     # sharded layouts on four GPUs
  JAX_PLATFORMS=cpu python chip_smoke.py --tiny --rehearse-on-cpu
  JAX_PLATFORMS=cpu python chip_smoke.py --tiny --rehearse-on-cpu --four-cards
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import sys
import threading
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# (preset, synthetic geometry) — every preset the library phase drives.
PRESETS = (
    ("kitti_sep", "kitti"),
    ("kitti_seplo", "kitti"),
    ("kitti_tiled", "kitti"),
    ("kitti_sgm", "kitti"),
    ("middlebury_asw_full", "venus"),
    ("tsukuba_ad_box", "tsukuba"),
)
# --tiny: the same presets on small scenes (rehearsal only).
# Odd heights on purpose: the layouts must pad rows that do not divide.
TINY_GEOM = {"kitti": (47, 128, 16), "venus": (48, 96, 16),
             "tsukuba": (48, 64, 8)}
TINY_RADIUS = 4
ORACLE_CROP = (48, 64, 16, 4)  # H, W, D, r
BAD2_MAX = 0.05
BATCH_TOL_PX, BATCH_SHARE = 1e-4, 0.9999
WTA_SHARE, DISP_TOL_PX = 0.999, 1e-4
SHARD_TOL_PX, SHARD_SHARE = 1e-4, 0.9999


class CheckFailed(AssertionError):
    """A phase's result is outside its bound."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded layouts on four cards")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink every geometry (rehearsal)")
    ap.add_argument("--rehearse-on-cpu", action="store_true",
                    help="let the device phase accept the CPU (rehearsal)")
    return ap.parse_args(argv)


def plan(args) -> list[str]:
    """Phase names, in order."""
    if args.four_cards:
        return ["device", "four_cards"]
    return ["device", "library", "hard_pins", "oracle", "cli", "server"]


class Smoke:
    def __init__(self, args):
        self.args = args
        self.card = "not available (CPU rehearsal)"
        self.compile_s = 0.0

    # -- helpers --------------------------------------------------------
    def scene(self, geom: str, seed: int):
        from aswstereomatch_tpu.utils import synthetic

        if self.args.tiny:
            h, w, d = TINY_GEOM[geom]
            return synthetic.make_pair(height=h, width=w, max_disparity=d,
                                       seed=seed)
        return synthetic.make_dataset_pair(geom, seed=seed)

    def preset_cfg(self, name: str, geom: str):
        from aswstereomatch_tpu.config import get_preset

        cfg = get_preset(name)
        if self.args.tiny:
            cfg = cfg.replace(max_disparity=TINY_GEOM[geom][2],
                              window_radius=min(cfg.window_radius,
                                                TINY_RADIUS))
        return cfg

    def timed_first(self, fn, *a):
        """First call (compile or cache load + one run), blocked."""
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a))
        dt = time.perf_counter() - t0
        self.compile_s += dt
        return out, dt

    # -- phases -----------------------------------------------------------
    def device(self):
        import jax

        from aswstereomatch_tpu.utils import device

        dev = jax.devices()[0]
        if dev.platform != "gpu" and not self.args.rehearse_on_cpu:
            device.require_gpu()  # raises NoGpuError
        if dev.platform == "gpu":
            self.card = device.card_line()
        print(f"card: {self.card}", flush=True)
        print(f"jax {jax.__version__}: {len(jax.devices())} x "
              f"{dev.platform}:{dev.device_kind}", flush=True)
        if self.args.four_cards:
            check(len(jax.devices()) >= 4,
                  f"--four-cards needs 4 devices, have {len(jax.devices())}")

    def library(self):
        import jax.numpy as jnp

        from aswstereomatch_tpu.models.pipeline import StereoMatcher
        from aswstereomatch_tpu.utils import evaluate

        for name, geom in PRESETS:
            cfg = self.preset_cfg(name, geom)
            D = cfg.max_disparity
            m = StereoMatcher(cfg)
            pairs = [self.scene(geom, s) for s in (0, 1)]
            ls = [jnp.asarray(p["left"]) for p in pairs]
            rs = [jnp.asarray(p["right"]) for p in pairs]
            d0, first = self.timed_first(m, ls[0], rs[0])
            steady = time_steady(m, ls[0], rs[0])
            singles = [np.asarray(d0), np.asarray(m(ls[1], rs[1]))]
            batch, bfirst = self.timed_first(
                m.batch, jnp.stack(ls), jnp.stack(rs)
            )
            batch = np.asarray(batch)
            bad2 = []
            for p, d in zip(pairs, singles):
                nonocc = ~p["occluded"]
                bad2.append(evaluate.bad_delta(d, p["gt"], 2.0, nonocc))
                density = float(np.mean(np.isfinite(d) & (d >= 0)))
                check(density == 1.0, f"{name}: density {density}")
                check(bool(np.all((d >= 0) & (d < D))),
                      f"{name}: values outside [0, {D})")
            agree = min(
                float(np.mean(np.abs(batch[i] - singles[i]) <= BATCH_TOL_PX))
                for i in range(2)
            )
            h, w = singles[0].shape
            print(
                f"[library] {name} {w}x{h} D={D}: first call "
                f"{first:.2f} s (batch {bfirst:.2f} s), steady "
                f"{steady:.5f} s/pair, bad-2.0 {bad2[0]:.5f}/{bad2[1]:.5f}, "
                f"density 1.0, batch==single {agree:.6f} "
                f"[card: {self.card}]",
                flush=True,
            )
            check(max(bad2) < BAD2_MAX,
                  f"{name}: bad-2.0 {max(bad2):.4f} >= {BAD2_MAX}")
            check(agree >= BATCH_SHARE,
                  f"{name}: batch==single on {agree:.6f} < {BATCH_SHARE}")

    def hard_pins(self):
        import functools

        import jax
        import jax.numpy as jnp

        from aswstereomatch_tpu.config import (
            HARD_PIN_CFG, HARD_PINS, StereoConfig,
        )
        from aswstereomatch_tpu.models import pipeline
        from aswstereomatch_tpu.utils import evaluate, synthetic

        base = StereoConfig(**HARD_PIN_CFG)
        pairs = {s: synthetic.make_hard_pair(96, 160, 24, seed=s)
                 for s in (0, 1)}
        for mode, over, bounds in HARD_PINS:
            fn = jax.jit(functools.partial(
                pipeline.match_pair, cfg=base.replace(**over)))
            for seed, p in pairs.items():
                d, _ = self.timed_first(
                    fn, jnp.asarray(p["left"]), jnp.asarray(p["right"]))
                d = np.asarray(d)
                nonocc = ~p["occluded"]
                bad2 = evaluate.bad_delta(d, p["gt"], 2.0, nonocc)
                epe = float(np.abs(d - p["gt"])[nonocc].mean())
                b_max, e_max = bounds[seed]
                print(f"[hard_pins] {mode} seed {seed}: bad-2.0 {bad2:.4f} "
                      f"(<= {b_max}), EPE {epe:.3f} (<= {e_max})",
                      flush=True)
                check(bad2 <= b_max and epe <= e_max,
                      f"{mode} seed {seed}: bad-2.0 {bad2:.4f} / EPE "
                      f"{epe:.3f} over the pin")

    def oracle(self):
        import functools

        import jax
        import jax.numpy as jnp

        from aswstereomatch_tpu.config import get_preset
        from aswstereomatch_tpu.models import oracle_numpy, pipeline
        from aswstereomatch_tpu.ops import wta
        from aswstereomatch_tpu.utils import synthetic

        h, w, D, r = ORACLE_CROP
        p = synthetic.make_pair(height=h, width=w, max_disparity=D, seed=0)
        l, rr = jnp.asarray(p["left"]), jnp.asarray(p["right"])
        seen = set()
        for name, _ in PRESETS:
            cfg = get_preset(name).replace(
                max_disparity=D, window_radius=r, mesh_data=1, mesh_tile=1)
            if cfg.config_hash() in seen:  # same flags at crop size
                print(f"[oracle] {name}: same crop config as an earlier "
                      "preset, checked there", flush=True)
                continue
            seen.add(cfg.config_hash())
            vol = jax.jit(functools.partial(
                pipeline.aggregated_volume, cfg=cfg))(l, rr)
            wta_dev = np.asarray(wta.wta(vol))
            disp_dev, _ = self.timed_first(
                jax.jit(functools.partial(pipeline.match_pair, cfg=cfg)),
                l, rr)
            disp_dev = np.asarray(disp_dev)
            t0 = time.perf_counter()
            vol_o = oracle_numpy.aggregated_volume(p["left"], p["right"], cfg)
            disp_o = oracle_numpy.disparity_from_volume(vol_o, p["left"], cfg)
            t_orc = time.perf_counter() - t0
            same_wta = wta_dev == oracle_numpy.wta(vol_o)
            share = float(same_wta.mean())
            close = np.abs(disp_dev - disp_o) <= DISP_TOL_PX
            worst = float(np.abs(disp_dev - disp_o)[same_wta].max())
            print(f"[oracle] {name} {w}x{h} D={D} r={r}: WTA identical "
                  f"{share:.5f}, max |d| where WTA agrees {worst:.2e} px, "
                  f"within {DISP_TOL_PX} px {float(close.mean()):.5f} "
                  f"(oracle {t_orc:.1f} s)", flush=True)
            check(share >= WTA_SHARE,
                  f"{name}: WTA identical on {share:.5f} < {WTA_SHARE}")
            check(worst <= DISP_TOL_PX,
                  f"{name}: |d| {worst:.2e} px where WTA agrees")

    def cli(self):
        sys.path.insert(0, REPO)
        import cli

        argv = (["--synthetic", "tsukuba", "--preset", "tsukuba_ad_box"]
                if self.args.tiny else
                ["--synthetic", "kitti", "--preset", "kitti_sep"])
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        dt = time.perf_counter() - t0
        self.compile_s += dt
        check(rc == 0, f"cli exit code {rc}")
        rec = json.loads(buf.getvalue())
        bad2 = rec["metrics"]["bad_2"]
        print(f"[cli] {' '.join(argv)}: rc 0 in {dt:.2f} s, shape "
              f"{rec['shape']}, bad-2.0 {bad2}, density {rec['density']}, "
              f"{rec['pairs_per_s']} pairs/s [card: {self.card}]",
              flush=True)
        check(bad2 < BAD2_MAX, f"cli bad-2.0 {bad2}")
        check(rec["density"] == 1.0, f"cli density {rec['density']}")

    def server(self):
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import serve

        geom, preset = ("tsukuba", "tsukuba_ad_box") if self.args.tiny \
            else ("kitti", "kitti_sep")
        p = self.scene(geom, 0)
        srv = serve.Server(("127.0.0.1", 0))
        port = srv.server_address[1]
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=900) as sock:
                cfg = {"preset": preset}
                t0 = time.perf_counter()
                d32, h32 = serve.send_request(
                    sock, p["left"], p["right"], cfg)
                d16, h16 = serve.send_request(
                    sock, p["left"].astype(np.uint8),
                    p["right"].astype(np.uint8), cfg, dtype="uint8",
                    response_dtype="uint16_x256")
                dc, hc, uniq, lrv = serve.send_request(
                    sock, p["left"], p["right"], cfg, confidence=True)
                dt = time.perf_counter() - t0
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=30)
        self.compile_s += dt
        diff = float(np.abs(d32 - d16).max())
        print(f"[server] {preset} f32 {h32['elapsed_ms']} ms, "
              f"uint8->uint16_x256 {h16['elapsed_ms']} ms, confidence "
              f"{hc['elapsed_ms']} ms (3 requests incl. compiles "
              f"{dt:.2f} s); max |f32 - u16| {diff:.5f} px", flush=True)
        check(diff <= 1.0 / 256, f"f32 vs uint16 responses differ by {diff}")
        check(np.array_equal(dc, d32), "confidence disparity != f32 reply")
        check(uniq.shape == lrv.shape == d32.shape, "confidence plane shape")

    def four_cards(self):
        import jax

        devs = jax.devices()[:4]
        rows = sharded_phase(self.preset_cfg("kitti_sep", "kitti"),
                             [self.scene("kitti", s) for s in range(4)],
                             devs, report=self.report_shard)
        for row in rows:
            check(row["share"] >= SHARD_SHARE,
                  f"{row['layout']}: {row['share']:.6f} < {SHARD_SHARE}")

    def report_shard(self, row):
        print(f"[four_cards] {row['layout']}: bit-exact "
                  f"{row['bit_exact']}, max |d| {row['max_abs']:.3e} px, "
                  f"within {SHARD_TOL_PX} px {row['share']:.6f}, winner "
                  f"flips (|d| > 0.5) {row['flips']:.6f}, first call "
                  f"{row['first_s']:.2f} s, sharded {row['sharded_s']:.3f} s "
                  f"[card: {self.card}]",
                  flush=True)


def time_steady(fn, *a, iters: int = 3) -> float:
    """Median seconds per call after warm-up, each call blocked."""
    import jax

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


LAYOUTS = ("y_tiles", "x_tiles", "d_shards", "batch_2x2")


def sharded_phase(cfg, pairs, devices, layouts=LAYOUTS, report=None):
    """Each sharded layout on ``devices`` (4) vs single-device runs on
    ``devices[0]``: y-tiles, x-tiles, d-shards of ``pairs[0]`` over a 1x4
    mesh, and the 2x2 data x tile batch over ``pairs`` (4).  Returns one
    row per layout: ``{layout, bit_exact, max_abs, share, flips, first_s,
    sharded_s}``; ``report(row)`` is called as each row completes."""
    import functools

    import jax
    import jax.numpy as jnp

    from aswstereomatch_tpu.models import pipeline
    from aswstereomatch_tpu.parallel import dshard, mesh as mesh_lib, tiling

    cfg = cfg.replace(mesh_data=1, mesh_tile=1)
    single = jax.jit(functools.partial(pipeline.match_pair, cfg=cfg))
    d0 = devices[0]
    n_ref = len(pairs) if "batch_2x2" in layouts else 1
    refs = np.stack([
        np.asarray(single(jax.device_put(jnp.asarray(p["left"]), d0),
                          jax.device_put(jnp.asarray(p["right"]), d0)))
        for p in pairs[:n_ref]
    ])
    l0, r0 = jnp.asarray(pairs[0]["left"]), jnp.asarray(pairs[0]["right"])
    m14 = mesh_lib.build_mesh(data=1, tile=4, devices=devices)
    pair_fns = {"y_tiles": tiling.match_pair_tiled,
                "x_tiles": tiling.match_pair_tiled_x,
                "d_shards": dshard.match_pair_dsharded}
    rows = []
    for layout in layouts:
        if layout == "batch_2x2":
            m22 = mesh_lib.build_mesh(data=2, tile=2, devices=devices)
            # unsharded inputs: the jitted layout pads rows that do not
            # divide by the tile count before sharding them
            args = (jnp.stack([jnp.asarray(p["left"]) for p in pairs]),
                    jnp.stack([jnp.asarray(p["right"]) for p in pairs]))
            f = jax.jit(functools.partial(
                tiling.match_batch_sharded, cfg=cfg, device_mesh=m22))
            want = refs
        else:
            args = (l0, r0)
            f = jax.jit(functools.partial(
                pair_fns[layout], cfg=cfg, device_mesh=m14))
            want = refs[:1]
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))  # compile + one run
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = np.asarray(jax.block_until_ready(f(*args)))
        dt = time.perf_counter() - t0
        diff = np.abs(out.reshape(want.shape) - want)
        rows.append({
            "layout": layout,
            "bit_exact": bool(np.array_equal(out.reshape(want.shape), want)),
            "max_abs": float(diff.max()),
            "share": float(np.mean(diff <= SHARD_TOL_PX)),
            "flips": float(np.mean(diff > 0.5)),
            "first_s": first,
            "sharded_s": dt,
        })
        if report is not None:
            report(rows[-1])
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.four_cards and args.rehearse_on_cpu:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=4").strip()
    sys.path.insert(0, REPO)
    try:
        from aswstereomatch_tpu.utils import compile_cache, device
    except ImportError as e:
        print(f"[setup] FAILED: the aswstereomatch_tpu package is not "
              f"importable here ({e})", file=sys.stderr)
        return 2
    print(f"compile cache: {compile_cache.enable()}", flush=True)

    smoke = Smoke(args)
    failed = []
    for name in plan(args):
        t0 = time.perf_counter()
        try:
            getattr(smoke, name)()
        except Exception as e:  # noqa: BLE001 - reported; exit code says it
            failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s: "
                  f"{type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
            if name == "device":
                break  # nothing else may run off the card
            continue
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"smoke FAILED: {', '.join(failed)}", flush=True)
        return 1
    print(f"first calls (compile or cache load + one run) total "
          f"{smoke.compile_s:.1f} s [card: {smoke.card}]", flush=True)
    print(json.dumps({"ok": True, "device": device.jax_device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
