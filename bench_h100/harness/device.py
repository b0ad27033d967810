"""The card: its published peaks, its name and power limit, and the guards
a run keeps (enough cards, no JAX in the process)."""

from __future__ import annotations

import subprocess
import sys

import torch

# NVIDIA H100 SXM, dense rates without sparsity, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

# modules that may not be loaded in a run, compared by whole top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "blindshadowremoval_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names present in `modules` (sys.modules)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(n for n in FORBIDDEN_MODULES if n in names)


def cards_ok(chips: int) -> str | None:
    """None when CUDA is up with at least `chips` cards; else why not."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, torch sees "
                f"{torch.cuda.device_count()}")
    return None


def power_limit() -> str:
    """The card's power limit as nvidia-smi gives it, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"
    return out.splitlines()[0] if out else "not read"


def device_record(chips: int) -> dict:
    """The result line's `device`: platform, the card's name, the cards
    used, the peak bytes of the fullest, and its power limit."""
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak),
            "power_limit": power_limit()}
