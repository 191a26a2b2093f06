"""Minimal production serving daemon for the stereo engine.

A long-lived process with a warm jit cache serving disparity requests over a
local TCP socket with a length-prefixed binary protocol — the serving shape
for a latency-sensitive deployment (cameras pushing rectified pairs).  One
matcher per configured preset; first request per config pays the compile
(or a load from the persistent compilation cache), the rest run at device
speed.

Protocol (all little-endian):
  request:  u32 header_len | header JSON | left bytes | right bytes
            header: {"height", "width", "channels", "config": {...overrides},
                     "dtype": "float32" (default) | "uint8",
                     "response_dtype": "float32" (default) | "uint16_x256",
                     "confidence": false (default) | true}
  response: u32 header_len | header JSON | disparity bytes
            [| uniq_pct float32 H*W | lr_valid uint8 H*W when confidence]
            header: {"status": "ok", "height", "width", "elapsed_ms",
                     "dtype", "confidence"} or {"status": "error", "message"}

With "confidence": true the response appends the per-pixel WTA-uniqueness
margin (percent, float32) and the LR-validity mask — the selectable-
coverage surface: the consumer thresholds ``uniq_pct >= r`` downstream
instead of requesting a recompile per operating point (see
``pipeline.match_pair_with_confidence`` and ``tools/refuse_curve.py``).

The "uint16_x256" response format is the KITTI on-disk disparity
encoding (d*256 rounded to uint16, 1/256 px steps; invalid/negative -> 0).
It halves BOTH the device->host fetch and the response wire bytes.

The uint8 wire format is the production camera path: pixel values are
[0, 255] either way (uint8 is lossless for integral images), but it ships
and host-to-device-transfers 4x fewer bytes.  The widen to float32 happens
on device.

Protocol limits (hardening — any client integer is untrusted; nothing is
allocated before validation):
  - header_len in (0, 1 MiB]; the header must decode as a JSON object.
  - height/width are integers in [1, 16384], channels is 1 or 3, and each
    image plane is capped at 256 MiB; "dtype" must be float32 or uint8.
  - Violations get a {"status": "error"} response and the connection is
    DROPPED: past a malformed header the stream position can no longer be
    trusted, so resyncing would just loop on garbage.  Errors raised after
    the body is fully consumed (e.g. a bad config value) keep the
    connection alive as before.
  - Handler sockets carry an idle timeout (--idle-timeout, default 300 s):
    a stalled or vanished client releases its thread instead of pinning it
    forever.  Compiles don't count against it (the clock only runs while
    blocked on the socket).

Run:   python tools/serve.py --port 9444
Test:  python tools/serve.py --self-test   (spawns the server, sends a pair)
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import socket
import socketserver
import struct
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def send_request(sock, left: np.ndarray, right: np.ndarray, config: dict,
                 dtype: str = "float32", response_dtype: str = "float32",
                 confidence: bool = False):
    """One request/response round trip.

    Returns ``(disp, rheader)``, or with ``confidence=True``
    ``(disp, rheader, uniq_pct, lr_valid)`` — the per-pixel WTA-uniqueness
    margin (float32, percent) and LR-validity mask, so the caller picks
    its coverage operating point by thresholding (see
    ``pipeline.match_pair_with_confidence``)."""
    header = {
        "height": left.shape[0],
        "width": left.shape[1],
        "channels": 1 if left.ndim == 2 else left.shape[2],
        "config": config,
        "dtype": dtype,
        "response_dtype": response_dtype,
        "confidence": confidence,
    }
    wire = np.dtype(dtype)
    hb = json.dumps(header).encode()
    sock.sendall(struct.pack("<I", len(hb)))
    sock.sendall(hb)
    sock.sendall(np.ascontiguousarray(left, wire).tobytes())
    sock.sendall(np.ascontiguousarray(right, wire).tobytes())
    rlen = struct.unpack("<I", _recv_exact(sock, 4))[0]
    rheader = json.loads(_recv_exact(sock, rlen))
    if rheader.get("status") != "ok":
        raise RuntimeError(rheader.get("message", "server error"))
    h, w = rheader["height"], rheader["width"]
    if rheader.get("dtype") == "uint16_x256":
        raw = np.frombuffer(_recv_exact(sock, h * w * 2), np.uint16)
        disp = (raw.astype(np.float32) / 256.0).reshape(h, w)
    else:
        disp = np.frombuffer(_recv_exact(sock, h * w * 4), np.float32).reshape(
            h, w
        )
    if rheader.get("confidence"):
        uniq = np.frombuffer(
            _recv_exact(sock, h * w * 4), np.float32
        ).reshape(h, w)
        lrv = np.frombuffer(_recv_exact(sock, h * w), np.uint8).reshape(
            h, w
        ).astype(bool)
        return disp, rheader, uniq, lrv
    return disp, rheader


# Protocol limits — see the module docstring.  All are checked BEFORE any
# allocation sized by a client integer.
MAX_HEADER_LEN = 1 << 20      # 1 MiB of config JSON is absurdly generous
MAX_DIM = 16384               # per image axis
MAX_BODY_BYTES = 1 << 28      # per image plane (256 MiB)


class _ProtocolError(ValueError):
    """Malformed framing/limits: respond, then DROP the connection — the
    stream position past the violation can no longer be trusted."""


def _dim(header: dict, key: str, lo: int, hi: int) -> int:
    v = header.get(key)
    if isinstance(v, bool) or not isinstance(v, int) or not lo <= v <= hi:
        raise _ProtocolError(f"{key} must be an integer in [{lo}, {hi}], got {v!r}")
    return v


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        import jax
        import jax.numpy as jnp

        from aswstereomatch_tpu.config import StereoConfig
        from aswstereomatch_tpu.models.pipeline import StereoMatcher

        cache = self.server.fn_cache
        self.request.settimeout(self.server.idle_timeout)
        while True:
            try:
                hlen = struct.unpack("<I", _recv_exact(self.request, 4))[0]
            except (ConnectionError, OSError):
                return  # peer closed, stalled past the idle timeout, reset
            drop = False
            try:
                if not 0 < hlen <= MAX_HEADER_LEN:
                    raise _ProtocolError(
                        f"header_len {hlen} outside (0, {MAX_HEADER_LEN}]"
                    )
                try:
                    header = json.loads(_recv_exact(self.request, hlen))
                except (ValueError, UnicodeDecodeError):
                    raise _ProtocolError("header is not valid JSON") from None
                if not isinstance(header, dict):
                    raise _ProtocolError("header must be a JSON object")
                h = _dim(header, "height", 1, MAX_DIM)
                w = _dim(header, "width", 1, MAX_DIM)
                c = _dim(header, "channels", 1, 3)
                if c == 2:
                    raise _ProtocolError("channels must be 1 or 3")
                try:
                    wire = np.dtype(header.get("dtype", "float32"))
                except TypeError:
                    raise _ProtocolError("unparseable wire dtype") from None
                if wire not in (np.dtype(np.float32), np.dtype(np.uint8)):
                    # Body length is dtype-dependent: an unknown dtype
                    # desyncs the stream, so this is a drop, not a keep.
                    raise _ProtocolError(f"unsupported wire dtype {wire}")
                n = h * w * c * wire.itemsize
                if n > MAX_BODY_BYTES:
                    raise _ProtocolError(
                        f"image plane {n} bytes exceeds cap {MAX_BODY_BYTES}"
                    )
                left = np.frombuffer(_recv_exact(self.request, n), wire)
                right = np.frombuffer(_recv_exact(self.request, n), wire)
                shape = (h, w) if c == 1 else (h, w, c)
                left = left.reshape(shape)
                right = right.reshape(shape)
                cdict = dict(header.get("config", {}))
                preset = cdict.pop("preset", None)
                if preset is not None:
                    from aswstereomatch_tpu.config import get_preset
                    import dataclasses

                    cfg = dataclasses.replace(get_preset(preset), **cdict)
                else:
                    cfg = StereoConfig(**cdict)
                want_conf = bool(header.get("confidence", False))
                key = (cfg.config_hash(), shape, left.dtype.str, want_conf)
                if key not in cache:
                    # One compile lock: concurrent first requests for the
                    # same program must not each pay the compile.
                    with self.server.compile_lock:
                        if key not in cache:
                            m = StereoMatcher(cfg)
                            entry = (
                                m.jit_confidence if want_conf else m.jit_pair
                            )
                            cache[key] = entry.lower(
                                jnp.asarray(left), jnp.asarray(right)
                            ).compile()
                rdtype = header.get("response_dtype", "float32")
                if rdtype not in ("float32", "uint16_x256"):
                    raise ValueError(f"unsupported response_dtype {rdtype}")
                t0 = time.perf_counter()
                l_dev, r_dev = jnp.asarray(left), jnp.asarray(right)
                uniq = lrv = None
                if want_conf:
                    disp, uniq, lrv = cache[key](l_dev, r_dev)
                else:
                    disp = cache[key](l_dev, r_dev)
                if rdtype == "uint16_x256":
                    # Encode on device: halves the device-to-host fetch.
                    disp = self.server.enc_u16(disp)
                disp = np.asarray(jax.block_until_ready(disp))
                rheader = {
                    "status": "ok",
                    "height": disp.shape[0],
                    "width": disp.shape[1],
                    "elapsed_ms": round(1e3 * (time.perf_counter() - t0), 2),
                    "dtype": rdtype,
                    "confidence": want_conf,
                }
                body = disp.tobytes()
                if want_conf:
                    # confidence planes ride fixed wires: uniqueness
                    # margin f32 then LR-validity u8 (H*W each)
                    body += np.asarray(uniq, np.float32).tobytes()
                    body += np.asarray(lrv).astype(np.uint8).tobytes()
            except _ProtocolError as e:  # report, then drop the connection
                rheader = {"status": "error", "message": f"protocol: {e}"}
                body = b""
                drop = True
            except (ConnectionError, socket.timeout):
                # Peer vanished or stalled mid-body: nothing to respond to.
                return
            except Exception as e:  # body consumed cleanly: report, keep serving
                rheader = {"status": "error", "message": f"{type(e).__name__}: {e}"}
                body = b""
            hb = json.dumps(rheader).encode()
            try:
                self.request.sendall(struct.pack("<I", len(hb)))
                self.request.sendall(hb)
                if body:
                    self.request.sendall(body)
            except (ConnectionError, OSError):
                return
            if drop:
                return


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, idle_timeout: float = 300.0):
        super().__init__(addr, _Handler)
        self.fn_cache = {}
        self.idle_timeout = idle_timeout
        import threading

        self.compile_lock = threading.Lock()

    @functools.cached_property
    def enc_u16(self):
        import jax
        import jax.numpy as jnp

        return jax.jit(
            lambda d: jnp.clip(jnp.round(d * 256.0), 0, 65535).astype(
                jnp.uint16
            )
        )


def self_test(port: int) -> int:
    import subprocess
    import tempfile

    # Server output goes to a file, not a pipe: an undrained pipe can fill
    # and deadlock the child.
    log = tempfile.NamedTemporaryFile(
        prefix="stereo_serve_", suffix=".log", delete=False
    )
    cmd = [sys.executable, os.path.abspath(__file__), "--port", str(port)]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    try:
        from aswstereomatch_tpu.utils import evaluate, synthetic

        pair = synthetic.make_pair(height=48, width=64, max_disparity=8, seed=0)
        cfgdict = dict(max_disparity=8, aggregation="asw", window_radius=2)
        deadline = time.time() + 60
        sock = None
        while time.time() < deadline:
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=2)
                break
            except OSError:
                time.sleep(0.3)
        assert sock is not None, "server did not come up"
        sock.settimeout(300)  # first request pays the jit compile
        with sock:
            d1, h1 = send_request(sock, pair["left"], pair["right"], cfgdict)
            d2, h2 = send_request(sock, pair["left"], pair["right"], cfgdict)
            bad2 = evaluate.bad_delta(d1, pair["gt"], 2.0, ~pair["occluded"])
            assert np.array_equal(d1, d2)
            assert bad2 < 0.05, bad2
            # warm path must be much faster than the compile call
            assert h2["elapsed_ms"] < h1["elapsed_ms"]
            # error path keeps the connection alive
            try:
                send_request(sock, pair["left"], pair["right"],
                             {"aggregation": "bogus"})
                raise AssertionError("expected error response")
            except RuntimeError as e:
                assert "bogus" in str(e)
            d3, _ = send_request(sock, pair["left"], pair["right"], cfgdict)
            assert np.array_equal(d3, d1)
        print(json.dumps({"self_test": "ok", "bad_2": round(float(bad2), 5),
                          "cold_ms": h1["elapsed_ms"], "warm_ms": h2["elapsed_ms"]}))
        return 0
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9444)
    ap.add_argument("--idle-timeout", type=float, default=300.0,
                    help="per-connection socket idle timeout in seconds; a "
                    "stalled client releases its handler thread instead of "
                    "pinning it forever")
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args()
    if args.self_test:
        sys.exit(self_test(args.port))
    from aswstereomatch_tpu.utils import compile_cache, devlock

    compile_cache.enable()
    # Hold the device for the daemon's lifetime: a second JAX process on
    # the card would fail for want of memory; with the lock a bench/sweep
    # started alongside fails fast, naming us.
    with devlock.device_lock("serve", timeout_s=60):
        srv = Server((args.host, args.port), idle_timeout=args.idle_timeout)
        print(f"serving on {args.host}:{args.port}", flush=True)
        srv.serve_forever()


if __name__ == "__main__":
    main()
