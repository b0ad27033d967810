"""The port's utils/profiling.py against the JAX package's on the CPU:
`StepTimer`'s statistics, `trace`'s Chrome trace and `device_time`'s
device rule."""

import glob
import json
import os

import pytest
import torch

from blindshadowremoval_tpu.utils import profiling as jax_profiling
from blindshadowremoval_tpu_torch.utils import profiling


def test_step_timer_matches_jax():
    """The same step times give the JAX StepTimer's statistics, and the
    window drops the oldest."""
    times = [0.010, 0.012, 0.011, 0.030, 0.009, 0.013]
    port, ref = profiling.StepTimer(window=5), jax_profiling.StepTimer(
        window=5)
    assert port.stats() == ref.stats() == {}
    for t in times:
        for timer in (port, ref):
            timer._times.append(t)
            if len(timer._times) > timer.window:
                timer._times.pop(0)
    assert port.stats(items_per_step=64) == ref.stats(items_per_step=64)
    with port:
        pass
    assert len(port._times) == 5 and port._times[-1] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace(logdir) writes a `.pt.trace.json` whose events name the ops
    run inside it, and yields the profiler."""
    with profiling.trace(str(tmp_path)) as prof:
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_device_time_reads_the_host_clock_only_when_asked():
    calls = []
    secs = profiling.device_time(lambda a: calls.append(a), 1, iters=4,
                                 device="cpu")
    assert calls == [1] * 5 and secs >= 0.0     # one warm-up, four timed
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiling.device_time(lambda: None)
