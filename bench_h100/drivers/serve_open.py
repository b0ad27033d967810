"""An open loop: single requests offered at a fixed rate with Poisson gaps
to the program's `BatchingFrontend` over the service (its defaults:
batches of the service's size, 5 ms to fill one), drawn from the request
pool.

Window: the requests due in `seconds`, each submitted when due by one
thread; the window closes when the last one's result is in (or a minute
past the last due time, after which a request counts as missing).  Each
request's latency runs from when it was due to when its future held the
result, so a stall of the submitting thread counts against the requests
behind it; how late the submitter ran is printed beside the result, with
what the frontend's threads did in the window, timed from outside by
host-clock spans on the service (harness/clock.py) that set-up puts on
after the warm-up and `release` takes off: each batch's collector,
hand-off and forward ms, and each thread's busy share.

The process hosts the frontend with the malloc tunables the traffic file
names, if any (harness/malloc.py), set before anything is built and put
back in `release`.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from bench_h100.harness import clock, inputs, malloc, serve

WAIT_AFTER_S = 60.0


def setup(run) -> None:
    from blindshadowremoval_tpu_torch.eval.serving import BatchingFrontend

    traffic = run.cell.traffic
    run.state["malloc"] = malloc.apply(traffic.get("malloc", {}))
    svc, _, photos, lms = serve.build(run, traffic["batch_size"])
    fe = BatchingFrontend(svc, max_delay_ms=traffic["max_delay_ms"])
    run.state["frontend"] = fe
    # the service's one batch shape, full and nearly empty
    futs = [fe.submit(photos[i % len(photos)], lms[i % len(lms)])
            for i in range(traffic["batch_size"])]
    for f in futs:
        f.result()
    for i in range(3):
        fe.submit(photos[i], lms[i]).result()
    run.state["clock"] = clock.time_service(svc)


def install_spans(run, spans) -> None:
    serve.install_spans(run, spans)


def release(run) -> None:
    fe = run.state.get("frontend")
    if fe is not None:
        fe.close()
    host = run.state.pop("clock", None)
    if host is not None:
        host.restore()
    undo = run.state.pop("malloc", None)
    if undo is not None:
        undo()
    serve.release(run)


def offer(run, rate: float, seconds: float) -> dict:
    """Offer `rate` requests/s for `seconds`; wait for every answer."""
    st = run.state
    fe, photos, lms = st["frontend"], st["photos"], st["lms"]
    due = inputs.poisson_schedule(run.seed, rate, seconds)
    perm = inputs.call_order(run.seed, 0, len(photos), len(photos))
    pick = [int(perm[k % len(perm)]) for k in range(len(due))]
    done = [0.0] * len(due)
    lock = threading.Lock()

    def finished(k):
        def mark(_):
            t = time.perf_counter()
            with lock:
                done[k] = t
        return mark

    host = st["clock"]
    host.clear()
    b0, r0 = fe.batches_dispatched, fe.requests_served
    futs, late = [], []
    t0 = time.perf_counter()
    for k, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(time.perf_counter() - (t0 + d))
        fut = fe.submit(photos[pick[k]], lms[pick[k]])
        fut.add_done_callback(finished(k))
        futs.append(fut)
    give_up = t0 + due[-1] + WAIT_AFTER_S
    answers, lat, missing = [], [], 0
    for k, fut in enumerate(futs):
        try:
            r = fut.result(timeout=max(0.0, give_up - time.perf_counter()))
        except Exception:     # not served by the end: missing, its wait
            missing += 1      # counts to the give-up time
            lat.append(give_up - (t0 + due[k]))
            continue
        r.pop("img", None)
        answers.append((pick[k], r))
        with lock:
            lat.append(done[k] - (t0 + due[k]))
    end = max([t0 + due[-1]] + [d for d in done if d])
    lat_ms = 1e3 * np.asarray(lat)
    late_ms = 1e3 * np.asarray(late)
    st["answers"] = answers
    threads = clock.summarize(host.records, end - t0)
    return {"window_s": end - t0, "attempted": len(due), "failed": missing,
            "units": len(answers), "latency_ms": lat_ms,
            "batches": fe.batches_dispatched - b0,
            "served": fe.requests_served - r0,
            "metrics": {"latency_p50_ms": float(np.percentile(lat_ms, 50))},
            "threads": threads, "late_ms": late_ms,
            "notes": [clock.quantiles("submitter lateness ms", late_ms),
                      clock.quantiles("latency ms", lat_ms)]
            + clock.notes(threads)}


def window(run, seconds: float) -> dict:
    return offer(run, run.cell.traffic["rate_per_s"], seconds)


def flops_per_unit(run) -> int:
    return serve.flops_per_face(run)


check = serve.check
control = serve.control
