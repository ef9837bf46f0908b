"""The GPU's name and power limit, for printing beside every measurement.

A card set below its maximum power limit runs slower under load, so a
time means little without them.
"""

from __future__ import annotations

import subprocess

_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
          "--format=csv,noheader"]


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    one line per card; raises if nvidia-smi is missing or fails."""
    out = subprocess.run(_QUERY, capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip()
