"""The card's name and power limit, for the records that tools write."""

import subprocess


def card_line():
    """``name, power limit`` of the first card as nvidia-smi gives them, or
    None without one."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None
