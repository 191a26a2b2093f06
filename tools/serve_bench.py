"""Load-test the serving daemon: request-latency percentiles on the GPU.

Spawns `tools/serve.py` (or targets a running one with --port), drives it
with concurrent TCP clients sending KITTI-geometry pairs at the
production preset (kitti_sep config), and reports per-request latency
p50/p90/p99 + aggregate throughput (the SURVEY §5 metrics/observability
row).

Each request ships 2 x H x W x 3 over loopback (~21 MB f32, ~5.3 MB
uint8 at KITTI) — wire time is part of the measured request latency, as
it would be in deployment.  Both wire dtypes are measured: uint8 is the
production camera format (lossless for integral [0,255] images) and
ships 4x fewer host-to-device bytes.  Writes
bench_results/serve_bench.json.

Usage: python tools/serve_bench.py [--requests 100] [--clients 4]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

from tools.serve import send_request


# The headline config: serving measures the same program bench.py does.
# (--preset overrides, e.g. kitti_sgm for the accuracy mode.)
CFG = dict(preset="kitti_sep")


def client(port, pairs, n_req, lat, srv_ms, spans, errors, barrier, dtype,
           rdtype):
    sock = socket.create_connection(("127.0.0.1", port), timeout=600)
    try:
        left, right = pairs
        # connection warmup (first request may pay AOT-load/compile + program
        # load) — excluded from the measured span, which starts at the
        # barrier so one client's compile can't inflate the phase wall time.
        send_request(sock, left, right, CFG, dtype=dtype,
                     response_dtype=rdtype)
        barrier.wait()
        start = time.perf_counter()
        for _ in range(n_req):
            t0 = time.perf_counter()
            _, hdr = send_request(sock, left, right, CFG, dtype=dtype,
                                  response_dtype=rdtype)
            lat.append(time.perf_counter() - t0)
            srv_ms.append(hdr["elapsed_ms"])
        spans.append((start, time.perf_counter()))
    except Exception as e:  # noqa: BLE001
        errors.append(f"{type(e).__name__}: {e}")
    finally:
        sock.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=100, help="total requests")
    ap.add_argument("--preset", default="kitti_sep")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--port", type=int, default=0,
                    help="target a running server instead of spawning one")
    args = ap.parse_args()
    CFG["preset"] = args.preset

    from aswstereomatch_tpu.utils import synthetic

    pair = synthetic.make_pair(height=375, width=1242, max_disparity=128,
                               seed=0)
    pairs = (np.asarray(pair["left"], np.float32),
             np.asarray(pair["right"], np.float32))

    proc = None
    port = args.port
    if not port:
        port = 9461
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "serve.py"),
             "--port", str(port)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        # wait for the listener
        for _ in range(120):
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                time.sleep(1)
    try:
        rec = {"preset": args.preset, "clients": args.clients, "wire": {}}
        for dtype, rdtype in (
            ("float32", "float32"),
            ("uint8", "float32"),
            ("uint8", "uint16_x256"),
        ):
            wire_pairs = pairs
            if dtype == "uint8":
                wire_pairs = tuple(p.astype(np.uint8) for p in pairs)
            lat, srv_ms, spans, errors = [], [], [], []
            per = args.requests // args.clients
            barrier = threading.Barrier(args.clients)
            threads = [
                threading.Thread(
                    target=client,
                    args=(port, wire_pairs, per, lat, srv_ms, spans, errors,
                          barrier, dtype, rdtype),
                )
                for _ in range(args.clients)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                print("ERRORS:", errors)
                return 1
            wall = max(e for _, e in spans) - min(s for s, _ in spans)
            ms = np.sort(np.array(lat) * 1e3)
            rec["wire"][f"{dtype}->{rdtype}"] = {
                "requests": len(lat),
                "p50_ms": float(np.percentile(ms, 50)),
                "p90_ms": float(np.percentile(ms, 90)),
                "p99_ms": float(np.percentile(ms, 99)),
                "max_ms": float(ms[-1]),
                "server_side_p50_ms": float(np.percentile(
                    np.array(srv_ms), 50)),
                "throughput_pairs_per_s": len(lat) / wall,
            }
        rec["note"] = (
            "wire key is request->response dtype; loopback TCP incl. wire "
            "transfer (21 MB/request f32, 5.3 MB uint8; response 1.8 MB "
            "f32, 0.9 MB uint16_x256 — the KITTI fixed-point encoding, "
            "1/256 px); one GPU, device access serialized across "
            "client threads; server_side = H2D + compute + D2H + sync, "
            "excluding wire."
        )
        suffix = "" if args.preset == "kitti_sep" else f"_{args.preset}"
        with open(os.path.join(REPO, "bench_results",
                               f"serve_bench{suffix}.json"), "w") as f:
            json.dump(rec, f, indent=2)
        print(json.dumps(rec, indent=2))
        return 0
    finally:
        if proc is not None:
            proc.terminate()
            proc.wait(timeout=10)


if __name__ == "__main__":
    sys.exit(main())
