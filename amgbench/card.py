"""What nvidia-smi reports of the card: the copy of
``sparsh_amg_tpu_torch/utils/meminfo.py::card_name_and_power_limit``."""
from __future__ import annotations

import subprocess


def name_and_power_limit() -> tuple:
    """(name, power limit in W or None) of the first card as nvidia-smi
    reports them (``--query-gpu=name,power.limit``); (None, None) where
    nvidia-smi is missing or fails."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None, None
    name, limit = (f.strip() for f in line.rsplit(",", 1))
    try:
        watts = float(limit.split()[0])
    except (ValueError, IndexError):       # "[N/A]" on some cards
        watts = None
    return name, watts
