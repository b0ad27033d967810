"""The dynamic-batching frontend against the raw batch API (counterpart of
`tools/bench_serving_frontend.py`).

Replays N single-image requests through `BatchingFrontend.submit()` from
client threads and compares the wall time and batch occupancy with one
`remove_shadows` call of the same N: what the latency-bounded coalescing
costs or buys over the hand-batched path the CLI uses.  The face is the
committed in-the-wild golden's (`tests/goldens/tf_ref/e2e_eval.npz`
`ffhq_input`, an aligned 256 px crop) with the canonical landmarks
(`geometry/landmarks.py:LM_REF`) placed on it; the JAX tool's sample
image is in the reference data, which this repository does not hold.
The service is the JAX tool's: the in-the-wild preset with compact wires,
Glorot-uniform weights from seed 0.  The text lines, then one JSON line.

    python -m blindshadowremoval_tpu_torch.tools.bench_serving_frontend \
        [--requests 128] [--max-delay-ms 5] [--clients 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path

import numpy as np

from blindshadowremoval_tpu_torch.config import get_config, resolve_device
from blindshadowremoval_tpu_torch.tools import _timing

SIZE = 256
N_RES = 6
GOLDEN = (Path(__file__).resolve().parents[2] / "tests" / "goldens"
          / "tf_ref" / "e2e_eval.npz")


def golden_face(golden: Path = GOLDEN) -> tuple[np.ndarray, np.ndarray]:
    """(the golden's 256 px face, f32 RGB in [0, 1]; LM_REF on it)."""
    from blindshadowremoval_tpu_torch.geometry.landmarks import LM_REF

    img = np.load(golden)["ffhq_input"].astype(np.float32)
    return img, (LM_REF * img.shape[0]).astype(np.float32)


def bench_frontend(requests: int = 128, max_delay_ms: float = 5.0,
                   clients: int = 8, batch_size: int = 32,
                   device=None) -> dict:
    """The JAX tool's three lines, printed; returns {"requests",
    "batch_api_s", "batch_api_req_per_s", "frontend_s",
    "frontend_req_per_s", "batches", "mean_occupancy", "max_delay_ms",
    "clients", "batch_size", "latency_mean_ms", "latency_p95_ms",
    "device"}."""
    from blindshadowremoval_tpu_torch.eval.serving import (
        BatchingFrontend,
        ShadowRemovalService,
    )

    dev = resolve_device(device)
    img, lm = golden_face()
    cfg = get_config("in_the_wild", img_size=SIZE, n_res=N_RES,
                     compact_output=True, compact_ingress=True)
    svc = ShadowRemovalService(cfg, batch_size=batch_size, device=dev)
    # warm both paths (kernel builds, cuDNN's algorithm search)
    svc.remove_shadows([img] * batch_size, [lm] * batch_size)

    n = requests
    t0 = time.perf_counter()
    outs = svc.remove_shadows([img] * n, [lm] * n)
    t_batch = time.perf_counter() - t0
    if len(outs) != n:
        raise RuntimeError(f"{len(outs)} results for {n} requests")

    fe = BatchingFrontend(svc, max_delay_ms=max_delay_ms)
    futs = [None] * n
    lat = [0.0] * n

    def client(lo, hi):
        for i in range(lo, hi):
            t = time.perf_counter()
            futs[i] = fe.submit(img, lm)
            futs[i].add_done_callback(
                lambda _f, i=i, t=t: lat.__setitem__(
                    i, time.perf_counter() - t))

    per = (n + clients - 1) // clients
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(c * per, min(n, (c + 1) * per)))
               for c in range(clients)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for f in futs:
            f.result(timeout=120.0)
        t_fe = time.perf_counter() - t0
    finally:
        fe.close()
    occ = fe.requests_served / max(1, fe.batches_dispatched)
    print(f"raw batch API   : {n} requests in {t_batch:.2f} s "
          f"= {n / t_batch:.1f} req/s")
    print(f"dynamic frontend: {n} requests in {t_fe:.2f} s "
          f"= {n / t_fe:.1f} req/s  "
          f"({fe.batches_dispatched} batches, mean occupancy {occ:.1f}/"
          f"{batch_size}, max_delay {max_delay_ms} ms, {clients} clients)")
    print(f"request latency : mean {1e3 * float(np.mean(lat)):.0f} ms  "
          f"p95 {1e3 * float(np.percentile(lat, 95)):.0f} ms")
    return {"requests": n, "batch_api_s": t_batch,
            "batch_api_req_per_s": n / t_batch, "frontend_s": t_fe,
            "frontend_req_per_s": n / t_fe,
            "batches": fe.batches_dispatched, "mean_occupancy": occ,
            "max_delay_ms": max_delay_ms, "clients": clients,
            "batch_size": batch_size,
            "latency_mean_ms": 1e3 * float(np.mean(lat)),
            "latency_p95_ms": 1e3 * float(np.percentile(lat, 95)),
            "device": _timing.device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m "
             "blindshadowremoval_tpu_torch.tools.bench_serving_frontend",
        description="BatchingFrontend under client threads against one "
                    "remove_shadows call")
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=32)
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(bench_frontend(args.requests, args.max_delay_ms,
                                    args.clients, args.batch_size,
                                    args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
