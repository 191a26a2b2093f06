"""The accelerator a measurement ran on, and the refusal to run without one.

Every timing this repo prints names its device: JAX's view
(``platform``, ``device_kind``, device count) and the card's own
(``nvidia-smi`` name and power limit — a card set below its maximum power
runs slower under load).  A measurement path that finds no GPU fails; it
never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import jax

NVIDIA_SMI = (
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
)


class NoGpuError(RuntimeError):
    """JAX's default device is not a GPU."""


def require_gpu():
    """Return ``jax.devices()[0]``; raise ``NoGpuError`` unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGpuError(
            f"no GPU visible to JAX (default device {dev.platform}:"
            f"{dev.device_kind}); refusing to measure on it"
        )
    return dev


def jax_device_record() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def parse_card_line(line: str) -> tuple[str, str]:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> (name, power limit).

    The name may itself hold commas, so the limit is the last field.
    """
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line {line!r}")
    return name.strip(), limit.strip()


def card_line(timeout_s: float = 30.0) -> str:
    """The first card's ``name, power.limit`` from ``nvidia-smi`` (a
    subprocess; it does not touch JAX).  Raises if the query fails."""
    out = subprocess.run(
        NVIDIA_SMI, capture_output=True, text=True, timeout=timeout_s,
        check=True,
    ).stdout
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi printed no card")
    parse_card_line(lines[0])
    return lines[0].strip()
