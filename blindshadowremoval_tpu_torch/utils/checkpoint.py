"""Checkpoint / resume with restore-latest semantics (port of
`blindshadowremoval_tpu/utils/checkpoint.py`).

The reference saves generator, discriminators and both optimizers once an
epoch and resumes from the latest, the epoch parsed from the file name
(train_test_GSC.py:142-148,166-173).  Here the whole `TrainState`
(`TrainState.state_dict()`: the step, G, D and VGG weights and statistics,
both Adam states by parameter name, the staircase count) goes into one
`torch.save` file a step, `<dir>/<step>.pt`, written to a temporary file
and moved into place, so a crash never leaves a half-written checkpoint.
The newest `max_to_keep` are kept.  A best-by-metric slot lives under
`<dir>/best`, its record in `<dir>/best_metric.json`.

The JAX package's Orbax checkpoints are not readable here (the card's
machine has no orbax): a JAX state crosses over as numpy through
`models/weights.py:train_state_from_jax`.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in
                  map(_STEP_FILE.match, os.listdir(directory)) if m)


class CheckpointManager:
    """save(step, state) / restore_latest(template), the best slot, and a
    generator-only restore for evaluation.  Tensors load onto `device`."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 device: str | torch.device = "cpu"):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.device = torch.device(device)
        os.makedirs(self.directory, exist_ok=True)

    # ----------------------------------------------------------- files
    @staticmethod
    def _write(directory: str, step: int, payload: dict) -> None:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{step}.pt")
        tmp = os.path.join(directory, f".{step}.pt.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def _read(self, directory: str, step: int, device=None) -> dict:
        return torch.load(os.path.join(directory, f"{step}.pt"),
                          map_location=device or self.device,
                          weights_only=True)

    # ------------------------------------------------------------ best
    @property
    def _best_dir(self) -> str:
        return os.path.join(self.directory, "best")

    @property
    def _best_meta_path(self) -> str:
        return os.path.join(self.directory, "best_metric.json")

    def best_record(self) -> Optional[dict]:
        """{'step': int, 'metric': float} of the retained best, or None."""
        try:
            with open(self._best_meta_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def save_best(self, step: int, state: Any, metric: float) -> bool:
        """Keep `state` under <dir>/best iff `metric` beats the record;
        True when the slot was updated.  The record survives restarts, so
        a resumed run compares against the all-time best."""
        rec = self.best_record()
        if rec is not None and metric <= rec["metric"]:
            return False
        self._write(self._best_dir, step, state.state_dict())
        for old in _steps(self._best_dir):
            if old != step:
                os.remove(os.path.join(self._best_dir, f"{old}.pt"))
        tmp = self._best_meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "metric": float(metric)}, f)
        os.replace(tmp, self._best_meta_path)
        return True

    def restore_best(self, template: Any) -> tuple[Any, int]:
        """Load the best checkpoint into `template`; (template, 0) if
        none."""
        rec = self.best_record()
        if rec is None:
            return template, 0
        template.load_state_dict(self._read(self._best_dir, rec["step"]))
        return template, rec["step"]

    # ---------------------------------------------------------- rolling
    def save(self, step: int, state: Any) -> None:
        """Write `state` (a TrainState) as checkpoint `step`, then drop
        all but the newest `max_to_keep`."""
        self._write(self.directory, step, state.state_dict())
        for old in _steps(self.directory)[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"{old}.pt"))

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        """The steps of the rolling checkpoints on disk, oldest first."""
        return _steps(self.directory)

    def restore_latest(self, template: Any) -> tuple[Any, int]:
        """Load the newest checkpoint into `template` (a TrainState, in
        place); (template, 0) if nothing is saved yet, as the reference's
        restore-or-init."""
        step = self.latest_step()
        if step is None:
            return template, 0
        template.load_state_dict(self._read(self.directory, step))
        return template, step

    def restore_eval(self, template: Optional[dict] = None
                     ) -> tuple[Optional[dict], int]:
        """The generator's state_dict of the newest checkpoint, and its
        step; (template, 0) when nothing is saved yet.  It reads nothing
        else, so it does not care how the run was optimized: a checkpoint
        trained with the LR staircase restores into a constant-LR
        config.  The tensors come on the CPU, where `build_generator`
        loads them."""
        step = self.latest_step()
        if step is None:
            return template, 0
        return self._read(self.directory, step, "cpu")["gen"], step

    def close(self) -> None:
        """Nothing is pending: every save is written before it returns."""
