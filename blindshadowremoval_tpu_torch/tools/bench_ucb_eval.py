"""Per-image UCB evaluation latency: host-orchestrated against fused
(counterpart of `tools/bench_ucb_eval.py`).

Runs the UCB evaluator over the images twice, `run_one` (the
host-orchestrated path: the forward on the device, resizes and gates on
the host, the components and metrics on the device, several round trips
an image) and `run_one_fused` (`eval/fused.py`: one device pass an image),
and reports the first call's seconds (kernel builds, cuDNN's algorithm
search; "compile_s" under the JAX tool's key) and the seconds an image of
the calls after it.  Each call ends in host fetches of its metrics and
arrays, so the wall clock between images is an end-to-end latency.  The
host batches are parsed before the timed region.  Generator weights:
Glorot-uniform from seed 0.

`--data` (a glob of UCB input folders of PNGs with `.npy` landmarks, the
ground truth beside them under `gt/`) and `--part-mask-root` (the root of
the seven part-mask directories) are required: the JAX tool reads them
from the reference data, which this repository does not hold.

    python -m blindshadowremoval_tpu_torch.tools.bench_ucb_eval \
        --data 'ucb/input/*' --part-mask-root ucb [--images 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

from blindshadowremoval_tpu_torch.config import get_config, resolve_device
from blindshadowremoval_tpu_torch.tools import _timing

SIZE = 256
N_RES = 6


def bench_ucb_eval(data: str, part_mask_root: str, images: int = 8,
                   views: int = 1, dtype: str = "bfloat16",
                   compact_ingress: bool = False, device=None) -> dict:
    """The JAX tool's record: {"bench": "ucb_eval", "views", "dtype",
    "compact_ingress", "host": {"compile_s", "per_image_s"}, "fused":
    {...}, "device"}; prints each path's line as it finishes."""
    from blindshadowremoval_tpu_torch.data.dataset import Dataset
    from blindshadowremoval_tpu_torch.eval.evaluators import UCBEvaluator

    dev = resolve_device(device)
    print("backend:", dev.type, _timing.device_label(dev))
    with tempfile.TemporaryDirectory(prefix="bench_ucb_") as work:
        cfg = get_config(
            "ucb", img_size=SIZE, n_res=N_RES, data_dirs_test=(data,),
            eval_views=views, compute_dtype=dtype,
            part_mask_root=part_mask_root, compact_ingress=compact_ingress,
            checkpoint_dir=work)
        ev = UCBEvaluator(cfg, device=dev)
        items = []
        for i, (batch, box, name) in zip(range(images),
                                         Dataset(cfg, "test")):
            items.append((batch, box, name, ev._load_part_masks(
                part_mask_root, i, sample_name=name)))
        if len(items) < 2:
            raise ValueError(f"{data!r} holds {len(items)} UCB image(s); "
                             "the timing needs 2 or more")
        results = {}
        for label, runner in (("host", ev.run_one),
                              ("fused", ev.run_one_fused)):
            t_first = time.perf_counter()
            runner(*_args(items[0], label))
            compile_s = time.perf_counter() - t_first
            t0 = time.perf_counter()
            for item in items[1:]:
                runner(*_args(item, label))
            per_img = (time.perf_counter() - t0) / (len(items) - 1)
            results[label] = {"compile_s": round(compile_s, 2),
                              "per_image_s": round(per_img, 3)}
            print(label, results[label], flush=True)
    return {"bench": "ucb_eval", "views": views, "dtype": dtype,
            "compact_ingress": compact_ingress, **results,
            "device": _timing.device_label(dev)}


def _args(item, label):
    batch, box, name, parts = item
    return (batch, box, f"{label}_{name.split('/')[-1]}", parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.bench_ucb_eval",
        description="UCB evaluation seconds an image, host-orchestrated "
                    "against fused")
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--views", type=int, default=1)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--compact-ingress", action="store_true",
                    help="uint16 fixed-point view upload (the CLI default)")
    ap.add_argument("--data", required=True,
                    help="glob of the UCB input folders")
    ap.add_argument("--part-mask-root", required=True,
                    help="root of the seven UCB part-mask directories")
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(bench_ucb_eval(args.data, args.part_mask_root,
                                    args.images, args.views, args.dtype,
                                    args.compact_ingress, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
