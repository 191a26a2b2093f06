"""chip_smoke.py's CPU-reachable parts: the device refusal, the nvidia-smi
line parser, phase selection, and the sharded phase itself on 4 of the
virtual CPU devices at tiny size."""

import os
import subprocess
import sys

import jax
import pytest

from aswstereomatch_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_smoke_refuses_cpu(tmp_path):
    """Without the rehearsal switch the device phase fails on the CPU: the
    script exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "[device] FAILED" in out.stdout
    assert "NoGpuError" in out.stdout


@pytest.mark.parametrize(
    "line,name,limit",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3",
         "700.00 W"),
        ("NVIDIA H100 80GB HBM3, 500.00 W\n", "NVIDIA H100 80GB HBM3",
         "500.00 W"),
        ("Card, with a comma, [N/A]", "Card, with a comma", "[N/A]"),
    ],
    ids=["full_power", "capped_trailing_newline", "comma_in_name"],
)
def test_card_line_parser(line, name, limit):
    assert device.parse_card_line(line) == (name, limit)


def test_card_line_parser_rejects_garbage():
    for bad in ("", "no comma here", ", 700 W", "H100, "):
        with pytest.raises(ValueError):
            device.parse_card_line(bad)


@pytest.mark.parametrize(
    "argv,phases",
    [
        ([], ["device", "library", "hard_pins", "oracle", "cli", "server"]),
        (["--four-cards"], ["device", "four_cards"]),
        (["--four-cards", "--tiny", "--rehearse-on-cpu"],
         ["device", "four_cards"]),
    ],
    ids=["one_card", "four_cards", "four_cards_rehearsal"],
)
def test_phase_selection(argv, phases):
    assert chip_smoke.plan(chip_smoke.parse_args(argv)) == phases


@pytest.fixture(scope="module")
def tiny_kitti():
    smoke = chip_smoke.Smoke(chip_smoke.parse_args(["--tiny"]))
    cfg = smoke.preset_cfg("kitti_sep", "kitti")
    pairs = [smoke.scene("kitti", s) for s in range(4)]
    return cfg, pairs


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
def test_sharded_phase_on_four_virtual_devices(tiny_kitti, layout):
    cfg, pairs = tiny_kitti
    (row,) = chip_smoke.sharded_phase(cfg, pairs, jax.devices()[:4],
                                      layouts=(layout,))
    assert row["layout"] == layout
    # the CPU backend keeps the tiled == untiled invariant bit-exact
    assert row["bit_exact"], row
    assert row["share"] == 1.0 and row["max_abs"] == 0.0


@pytest.mark.gpu
def test_smoke_phases_on_card(gpu_device):
    """The one-card smoke's phases at tiny geometry, on the card."""
    smoke = chip_smoke.Smoke(chip_smoke.parse_args(["--tiny"]))
    for name in chip_smoke.plan(smoke.args):
        getattr(smoke, name)()
