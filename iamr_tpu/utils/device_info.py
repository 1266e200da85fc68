"""What the run was measured on: JAX's device record and the card's own.

Every printed measurement carries these fields, so a number is never read
without the device, the card and its power limit beside it.
"""

from __future__ import annotations

import subprocess
from typing import Dict


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, as the
    tool prints it (e.g. "NVIDIA H100 80GB HBM3, 700.00 W")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def device_record() -> Dict[str, object]:
    """platform / device_kind / count as JAX reports them."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def require_gpu() -> Dict[str, object]:
    """The device record, or RuntimeError when JAX found no GPU: a number
    measured anywhere else is not a device metric."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {rec['platform']} "
            f"({rec['kind']}); device measurements need the card"
        )
    return rec
