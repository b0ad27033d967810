"""The port stands alone: neither blindshadowremoval_tpu_torch nor its
scripts at the root (chip_smoke.py, compare_kernels.py) import JAX, Flax,
cv2, PIL, natsort, sklearn or the JAX package (the machine with the card
has none of them)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "cv2", "PIL", "natsort", "sklearn",
             "blindshadowremoval_tpu")


def _port_sources():
    files = sorted((ROOT / "blindshadowremoval_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "compare_kernels.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_check_covers_the_tools():
    """The measurement tools (`blindshadowremoval_tpu_torch/tools/`) are
    among the sources checked above: none may import the JAX package,
    bench.py or the repository's tools/ either."""
    tools = sorted((ROOT / "blindshadowremoval_tpu_torch" / "tools").glob(
        "*.py"))
    assert len(tools) == 17          # __init__.py and the 16 tools
    assert set(tools) <= set(_port_sources())
    for path in tools:
        roots = set(_imported_roots(path))
        assert not roots & (set(FORBIDDEN) | {"bench", "tools"}), path


def test_port_runs_with_jax_blocked():
    """Import every port module, build the generator on the CPU and run the
    evaluation modules' image I/O with `jax`, `flax`, `cv2`, `PIL`,
    `natsort` and `sklearn` made unimportable."""
    code = """
import sys, tempfile, os
for name in ("jax", "flax", "cv2", "PIL", "natsort", "sklearn"):
    sys.modules[name] = None
import pkgutil, importlib
import blindshadowremoval_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
import numpy as np
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data.dataset import Dataset
from blindshadowremoval_tpu_torch.eval.evaluators import (
    InTheWildEvaluator, SFWEvaluator, SFWVideoEvaluator, UCBEvaluator)
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.utils.logging import TrainLogger
gen = build_generator(get_config(compute_dtype="float32", n_res=2),
                      device="cpu")
for variant in ("tsm", "rgb"):
    build_generator(get_config(variant=variant, compute_dtype="float32",
                               n_res=2), device="cpu")
ds = Dataset(get_config("sfw", variant="gsc", data_dirs_test=(
    "tests/goldens/tf_ref/sfw_gsc_synth/*",)), "test", dset="sfw")
assert len(ds.name_list) == 1
with tempfile.TemporaryDirectory() as d:
    path = TrainLogger(d).save_result_image(
        [np.zeros((1, 8, 8, 3), np.float32)], "a/b")
    assert os.path.getsize(path) > 0
assert "blindshadowremoval_tpu" not in sys.modules
print(type(gen).__name__)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "GSCGenerator"
