"""Dataset sweep with checkpoint/resume — the production batch driver.

Runs a configured matcher over every pair in a directory, with the sweep
manifest (utils/manifest.py) making the job resumable after any crash /
preemption (SURVEY.md section 5: recovery is re-dispatch of unfinished
pairs).  Pairs follow the layout ``<dir>/<id>_left.<ext>`` +
``<dir>/<id>_right.<ext>`` with optional ``<id>_gt.pfm``; disparity maps are
written as ``<id>_disp.pfm`` next to a JSON metrics record per pair.

``--make-synthetic N`` first materializes a demo dataset of N synthetic
pairs (with exact GT) so the tool is runnable end-to-end in this
environment.

Usage:
  python tools/sweep.py --dir /tmp/sweepdata --make-synthetic 8 \\
      --preset middlebury_asw_full --max-disparity 16 --window-radius 4
  # interrupt and re-run: completed pairs are skipped via the manifest
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_synthetic_dataset(dir_: str, n: int, height: int, width: int, max_d: int):
    from aswstereomatch_tpu.utils import io, synthetic

    os.makedirs(dir_, exist_ok=True)
    for i in range(n):
        pid = f"pair{i:04d}"
        pair = synthetic.make_pair(
            height=height, width=width, max_disparity=max_d, seed=i
        )
        for side in ("left", "right"):
            arr = pair[side].astype(np.uint8)
            with open(os.path.join(dir_, f"{pid}_{side}.ppm"), "wb") as f:
                f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
                f.write(arr.tobytes())
        io.write_pfm(os.path.join(dir_, f"{pid}_gt.pfm"), pair["gt"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--make-synthetic", type=int, default=0)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--preset", default="middlebury_asw_full")
    ap.add_argument("--max-disparity", type=int)
    ap.add_argument("--window-radius", type=int)
    ap.add_argument("--uniqueness-ratio", type=float,
                    help="cv2-style WTA-uniqueness confidence gate "
                    "(percent margin; 0 = off)")
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--queue-depth", type=int, default=4,
                    help="submit-ahead depth (in-flight device pairs)")
    ap.add_argument("--fetch", choices=["u16", "f32"], default="u16",
                    help="disparity device->host format: u16 = x256 "
                    "fixed point (the KITTI on-disk encoding, 1/256 px "
                    "quantization, 0 = invalid — halves the fetch bytes); "
                    "f32 = exact pipeline output")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from aswstereomatch_tpu.config import get_preset
    from aswstereomatch_tpu.models import pipeline
    from aswstereomatch_tpu.utils import evaluate, io, manifest
    from aswstereomatch_tpu.utils import native

    cfg = get_preset(args.preset)
    overrides = {
        k: getattr(args, k)
        for k in ("max_disparity", "window_radius", "uniqueness_ratio")
        if getattr(args, k) is not None
    }
    if overrides:
        cfg = cfg.replace(**overrides)

    gates_holes = cfg.lr_check or cfg.uniqueness_ratio > 0
    if args.fetch == "u16" and gates_holes and not cfg.fill_holes:
        # The u16 wire encodes invalid (-1) as 0 — KITTI's on-disk invalid
        # code, but io.write_pfm/evaluate below treat 0.0 as a legal zero
        # disparity, so hole-producing configs would score differently per
        # fetch mode.  Exact f32 keeps the -1 sentinel end-to-end.
        print(
            "note: fill_holes=False produces holes; forcing --fetch f32 "
            "to preserve the -1 invalid sentinel",
            file=sys.stderr,
        )
        args.fetch = "f32"

    if args.make_synthetic:
        make_synthetic_dataset(
            args.dir, args.make_synthetic, args.height, args.width,
            cfg.max_disparity,
        )

    read = native.read_pnm if native.available() else io.read_pnm
    pair_ids = sorted(
        os.path.basename(p)[: -len("_left.ppm")]
        for p in glob.glob(os.path.join(args.dir, "*_left.ppm"))
    )
    if not pair_ids:
        print(f"no pairs found in {args.dir}", file=sys.stderr)
        return 2

    match = pipeline.StereoMatcher(cfg)

    # Software pipelining: a dedicated SUBMITTER THREAD keeps a queue of
    # device work (depth args.queue_depth) ahead of the consumer loop, so
    # decode + H2D + dispatch for upcoming pairs overlap the current
    # pair's fetch + write + eval on the main thread.  All jax dispatch stays on the worker thread; the main thread only
    # fetches results and writes/records — the manifest contract (a pair
    # is recorded done only after its file is written) is unchanged.
    import threading

    pending: dict = {}
    cond = threading.Condition()
    sub_queue: list = []
    queued_ids: set = set()
    done_flag = [False]

    # uint16 x256 fixed-point device->host encoding (--fetch u16): the
    # literal KITTI on-disk convention (1/256 px steps; negative/invalid
    # -> 0, KITTI's invalid code); halving the bytes halves the fetch.
    @jax.jit
    def _enc_u16(disp):
        return jnp.clip(
            jnp.round(disp * 256.0), 0, 65535
        ).astype(jnp.uint16)

    def _as_device_input(a: np.ndarray) -> np.ndarray:
        # 8-bit sources ship as uint8 (4x fewer transfer bytes; widened to
        # f32 on device — lossless).  16-bit PNM (maxval >= 256) and float
        # sources must NOT take this path: astype(uint8) wraps modulo 256
        # and silently corrupts the images (same guard as cli.py).
        if float(np.min(a)) >= 0 and float(np.max(a)) <= 255 and np.all(
            a == np.floor(a)
        ):
            return a.astype(np.uint8)
        return a.astype(np.float32)

    def _submit_impl(pid: str):
        left = read(os.path.join(args.dir, f"{pid}_left.ppm"))
        right = read(os.path.join(args.dir, f"{pid}_right.ppm"))
        l = jnp.asarray(_as_device_input(left))
        r = jnp.asarray(_as_device_input(right))
        out = match(l, r)
        if args.fetch == "u16":
            out = _enc_u16(out)
        # Stage the device->host copy now, so by this pair's turn the
        # transfer has run behind the compute.
        out.copy_to_host_async()
        return out

    def _worker():
        while True:
            with cond:
                while not sub_queue and not done_flag[0]:
                    cond.wait(0.2)
                if not sub_queue:
                    return
                pid = sub_queue.pop(0)
            try:
                res = _submit_impl(pid)
            except Exception as e:  # noqa: BLE001 - re-raised on pid's turn
                res = e
            with cond:
                pending[pid] = res
                cond.notify_all()

    worker = threading.Thread(target=_worker, daemon=True)
    worker.start()

    def queue_submit(pid: str):
        with cond:
            if pid in queued_ids:
                return
            queued_ids.add(pid)
            sub_queue.append(pid)
            cond.notify_all()

    def process(pid: str, next_pids=()) -> dict:
        queue_submit(pid)
        # Enqueue successors before we block — a failed successor submit is
        # stored and re-raised on ITS OWN turn with correct attribution; it
        # never discards the current pair's finished computation or record.
        for nxt in next_pids:
            queue_submit(nxt)
        with cond:
            while pid not in pending:
                if not worker.is_alive():
                    raise RuntimeError(
                        "sweep submitter thread died; completed work is in "
                        "the manifest — re-run to resume"
                    )
                cond.wait(0.5)
            res = pending.pop(pid)
        if isinstance(res, Exception):
            raise res
        disp = np.asarray(res)
        if disp.dtype == np.uint16:
            disp = disp.astype(np.float32) / 256.0
        io.write_pfm(os.path.join(args.dir, f"{pid}_disp.pfm"), disp)
        rec = {"id": pid}
        gt_path = os.path.join(args.dir, f"{pid}_gt.pfm")
        if os.path.exists(gt_path):
            gt = io.read_pfm(gt_path)
            rec.update(
                {k: round(v, 5) for k, v in evaluate.bad_report(disp, gt).items()}
            )
        return rec

    mpath = args.manifest or os.path.join(args.dir, "sweep_manifest.json")
    from aswstereomatch_tpu.utils import devlock

    with devlock.device_lock("sweep", timeout_s=300):
        try:
            results = manifest.run_sweep(
                pair_ids, process, mpath, cfg.config_hash(), flush_every=1,
                pass_next=max(1, args.queue_depth),
            )
        finally:
            with cond:
                done_flag[0] = True
                cond.notify_all()
            worker.join(timeout=30)
    done = [r for r in results.values() if r]
    bad2 = [r["bad_2"] for r in done if "bad_2" in r]
    summary = {
        "pairs": len(done),
        "mean_bad_2": round(float(np.mean(bad2)), 5) if bad2 else None,
        "config_hash": cfg.config_hash(),
        "manifest": mpath,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    from aswstereomatch_tpu.utils import compile_cache

    compile_cache.enable()
    sys.exit(main())
