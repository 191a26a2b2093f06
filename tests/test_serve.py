"""Serving daemon end-to-end over a real socket (CPU backend)."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import serve as serve_mod  # noqa: E402

from aswstereomatch_tpu.utils import evaluate, synthetic  # noqa: E402


def _spawn_server(tmp_path, extra_args=()):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "serve.py"),
         "--port", str(port), *extra_args],
        stdout=log, stderr=subprocess.STDOUT, env=env,
    )
    return proc, port, log


def _connect(port, tmp_path, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=2)
            sock.settimeout(60)
            return sock
        except OSError:
            time.sleep(0.2)
    raise AssertionError((tmp_path / "server.log").read_text()[-2000:])


@pytest.mark.slow
def test_serve_end_to_end(tmp_path):
    proc, port, log = _spawn_server(tmp_path)
    try:
        pair = synthetic.make_pair(height=32, width=48, max_disparity=8, seed=0)
        cfgd = dict(max_disparity=8, aggregation="asw", window_radius=2)
        sock = _connect(port, tmp_path)
        sock.settimeout(180)
        with sock:
            d1, h1 = serve_mod.send_request(sock, pair["left"], pair["right"], cfgd)
            d2, h2 = serve_mod.send_request(sock, pair["left"], pair["right"], cfgd)
            assert np.array_equal(d1, d2)
            assert h2["elapsed_ms"] <= h1["elapsed_ms"]
            bad2 = evaluate.bad_delta(d1, pair["gt"], 2.0, ~pair["occluded"])
            assert bad2 < 0.05
            with pytest.raises(RuntimeError, match="bogus"):
                serve_mod.send_request(sock, pair["left"], pair["right"],
                                       {"aggregation": "bogus"})
            d3, _ = serve_mod.send_request(sock, pair["left"], pair["right"], cfgd)
            assert np.array_equal(d3, d1)
            # uint8 wire format: synthetic pairs are integral [0, 255], so
            # the u8 request is lossless and must match the f32-wire result
            # exactly (the widen to f32 happens on device).
            du, _ = serve_mod.send_request(
                sock, pair["left"].astype(np.uint8),
                pair["right"].astype(np.uint8), cfgd, dtype="uint8")
            assert np.array_equal(du, d1)
            # preset + override config path
            dp, _ = serve_mod.send_request(
                sock, pair["left"], pair["right"],
                {"preset": "tsukuba_ad_box", "max_disparity": 8,
                 "window_radius": 2})
            assert dp.shape == d1.shape
            # uint16_x256 response format: KITTI fixed-point encoding —
            # must match f32 within the 1/512 px rounding bound
            du16, hu = serve_mod.send_request(
                sock, pair["left"], pair["right"], cfgd,
                response_dtype="uint16_x256")
            assert hu["dtype"] == "uint16_x256"
            valid = d1 >= 0
            assert np.max(np.abs(du16 - d1)[valid]) <= 1 / 512 + 1e-6
            assert np.all(du16[~valid] == 0)
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        log.close()


def _read_response(sock):
    """One length-prefixed response header (no body expected on errors)."""
    import json
    import struct

    raw = serve_mod._recv_exact(sock, 4)
    rlen = struct.unpack("<I", raw)[0]
    return json.loads(serve_mod._recv_exact(sock, rlen))


def _assert_closed(sock):
    """The server must have dropped the connection (EOF, not a hang)."""
    sock.settimeout(10)
    assert sock.recv(1) == b""


@pytest.mark.slow
def test_serve_rejects_malformed_input(tmp_path):
    """Hardening battery: every malformed request gets an error response and
    a dropped connection (the stream can't be trusted past the violation),
    allocations never happen before validation, and the server stays alive
    for well-formed clients afterwards."""
    import json
    import struct

    proc, port, log = _spawn_server(tmp_path)
    try:
        def raw_case(payload: bytes, expect_msg: str):
            with _connect(port, tmp_path) as sock:
                sock.sendall(payload)
                rh = _read_response(sock)
                assert rh["status"] == "error", rh
                assert expect_msg in rh["message"], rh
                _assert_closed(sock)

        def header_case(header: dict, expect_msg: str, body: bytes = b""):
            hb = json.dumps(header).encode()
            raw_case(struct.pack("<I", len(hb)) + hb + body, expect_msg)

        # oversized header_len: would be a 4 GiB alloc if trusted
        raw_case(struct.pack("<I", 0xFFFFFFFF), "header_len")
        # zero header_len
        raw_case(struct.pack("<I", 0), "header_len")
        # header is not JSON
        raw_case(struct.pack("<I", 8) + b"notjson!", "not valid JSON")
        # header is JSON but not an object
        raw_case(struct.pack("<I", 4) + b"[12]", "JSON object")
        # absurd dims: would be a huge alloc if trusted
        header_case({"height": 1 << 30, "width": 64, "channels": 1}, "height")
        header_case({"height": 64, "width": -3, "channels": 1}, "width")
        header_case({"height": 64, "width": 64, "channels": 9}, "channels")
        header_case({"height": 64, "width": 64, "channels": 2}, "channels")
        # non-integer dims (type confusion)
        header_case({"height": "64", "width": 64, "channels": 1}, "height")
        header_case({"height": True, "width": 64, "channels": 1}, "height")
        # missing dims entirely
        header_case({"config": {}}, "height")
        # wrong dtype: body length would be undefined
        header_case(
            {"height": 4, "width": 4, "channels": 1, "dtype": "float64"},
            "wire dtype",
        )
        header_case(
            {"height": 4, "width": 4, "channels": 1, "dtype": [1, 2]},
            "dtype",
        )
        # per-plane byte cap (dims individually legal)
        header_case(
            {"height": 16384, "width": 16384, "channels": 3}, "exceeds cap"
        )

        # truncated body: client dies mid-image — server must not crash
        # and must free the handler (no response owed)
        hb = json.dumps({"height": 8, "width": 8, "channels": 1}).encode()
        with _connect(port, tmp_path) as sock:
            sock.sendall(struct.pack("<I", len(hb)) + hb + b"\x00" * 10)
        # server still alive: a well-formed request round-trips
        pair = synthetic.make_pair(height=32, width=48, max_disparity=8, seed=0)
        cfgd = dict(max_disparity=8, aggregation="box", window_radius=2,
                    lr_check=False, fill_holes=False, subpixel=False,
                    median_filter=False, cost="ad")
        with _connect(port, tmp_path) as sock:
            disp, rh = serve_mod.send_request(
                sock, pair["left"], pair["right"], cfgd
            )
            assert rh["status"] == "ok"
            assert disp.shape == (32, 48)
            # a bad CONFIG value (body consumed cleanly) keeps the
            # connection alive, unlike the protocol violations above
            with pytest.raises(RuntimeError, match="bogus"):
                serve_mod.send_request(sock, pair["left"], pair["right"],
                                       {"aggregation": "bogus"})
            disp2, _ = serve_mod.send_request(
                sock, pair["left"], pair["right"], cfgd
            )
            assert np.array_equal(disp2, disp)
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        log.close()


@pytest.mark.slow
def test_serve_idle_timeout_frees_handler(tmp_path):
    """A stalled client is disconnected after --idle-timeout instead of
    pinning its handler thread forever."""
    proc, port, log = _spawn_server(tmp_path, ("--idle-timeout", "2"))
    try:
        with _connect(port, tmp_path) as sock:
            # send nothing; the server should EOF us after ~2 s
            t0 = time.time()
            sock.settimeout(30)
            assert sock.recv(1) == b""
            assert time.time() - t0 < 25
        # server still serves after reaping the idle connection
        pair = synthetic.make_pair(height=16, width=32, max_disparity=4, seed=1)
        cfgd = dict(max_disparity=4, aggregation="box", window_radius=2,
                    lr_check=False, fill_holes=False, subpixel=False,
                    median_filter=False, cost="ad")
        with _connect(port, tmp_path) as sock:
            disp, rh = serve_mod.send_request(
                sock, pair["left"], pair["right"], cfgd
            )
            assert rh["status"] == "ok"
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        log.close()


@pytest.mark.slow
def test_serve_confidence_response(tmp_path):
    """"confidence": true appends the uniqueness margin + LR mask planes;
    thresholding them client-side reproduces the uniqueness_ratio gate."""
    proc, port, log = _spawn_server(tmp_path)
    try:
        pair = synthetic.make_pair(height=32, width=48, max_disparity=8, seed=2)
        cfgd = dict(max_disparity=8, aggregation="asw", window_radius=2,
                    lr_check=True, fill_holes=False, subpixel=True,
                    median_filter=False)
        with _connect(port, tmp_path) as sock:
            sock.settimeout(180)
            disp, rh, uniq, lrv = serve_mod.send_request(
                sock, pair["left"], pair["right"], cfgd, confidence=True)
            assert rh["confidence"] is True
            assert uniq.shape == disp.shape == lrv.shape == (32, 48)
            assert uniq.dtype == np.float32 and lrv.dtype == bool
            # LR mask consistent with the holes in the refuse-mode disp
            np.testing.assert_array_equal(lrv, disp >= 0)
            # thresholding reproduces the in-graph gate (same config +
            # uniqueness_ratio) served over the plain path
            gated, _ = serve_mod.send_request(
                sock, pair["left"], pair["right"],
                dict(cfgd, uniqueness_ratio=10.0))
            np.testing.assert_array_equal(lrv & (uniq >= 10.0), gated >= 0)
            # gate actually fires on this scene
            assert 0.3 < float(np.mean(gated >= 0)) < 1.0
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        log.close()


@pytest.mark.slow
def test_serve_confidence_with_u16_response(tmp_path):
    """confidence planes compose with the uint16_x256 disparity wire."""
    proc, port, log = _spawn_server(tmp_path)
    try:
        pair = synthetic.make_pair(height=24, width=40, max_disparity=8, seed=5)
        cfgd = dict(max_disparity=8, aggregation="asw", window_radius=2,
                    lr_check=True, fill_holes=False, subpixel=True,
                    median_filter=False)
        with _connect(port, tmp_path) as sock:
            sock.settimeout(180)
            d16, rh, uniq, lrv = serve_mod.send_request(
                sock, pair["left"], pair["right"], cfgd,
                response_dtype="uint16_x256", confidence=True)
            assert rh["dtype"] == "uint16_x256" and rh["confidence"] is True
            df, _, uniq2, lrv2 = serve_mod.send_request(
                sock, pair["left"], pair["right"], cfgd, confidence=True)
            # confidence planes are wire-format independent
            np.testing.assert_array_equal(uniq, uniq2)
            np.testing.assert_array_equal(lrv, lrv2)
            # u16 encodes invalid (-1) as 0; valid pixels match within
            # the fixed-point step
            valid = df >= 0
            assert np.max(np.abs(d16 - df)[valid]) <= 1 / 512 + 1e-6
            assert np.all(d16[~valid] == 0)
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        log.close()
