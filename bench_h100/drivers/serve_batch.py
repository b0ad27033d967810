"""A closed loop with one caller: each call is the service's
`remove_shadows` on `requests_per_call` requests in a seeded order over
the pool (each photo equally often), at the service's `batch_size`.

Window: calls back to back until `seconds` have passed; it closes when the
call in flight returns, and `faces_per_s` is every face returned over the
whole window.
"""

from __future__ import annotations

import time

from bench_h100.harness import inputs, serve

WARMUP_CALL = 2 ** 31     # a call index the window never draws


def setup(run) -> None:
    traffic = run.cell.traffic
    svc, _, photos, lms = serve.build(run, traffic["batch_size"])
    order = inputs.call_order(run.seed, WARMUP_CALL, len(photos),
                              traffic["requests_per_call"])
    svc.remove_shadows([photos[i] for i in order], [lms[i] for i in order])


install_spans = serve.install_spans
release = serve.release


def window(run, seconds: float) -> dict:
    traffic, st = run.cell.traffic, run.state
    svc, photos, lms = st["svc"], st["photos"], st["lms"]
    n = traffic["requests_per_call"]
    answers, missing, call, ends = [], 0, 0, []
    t0 = time.perf_counter()
    while True:
        order = inputs.call_order(run.seed, call, len(photos), n)
        out = svc.remove_shadows([photos[i] for i in order],
                                 [lms[i] for i in order])
        missing += n - len(out)
        for i, r in zip(order, out):
            r.pop("img", None)      # the request's own crop, not an answer
            answers.append((int(i), r))
        call += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    elapsed = ends[-1]
    st["answers"] = answers
    took = [round(b - a, 4) for a, b in zip([0.0] + ends, ends)]
    return {"window_s": elapsed, "attempted": call * n, "failed": missing,
            "units": len(answers),
            "metrics": {"faces_per_s": len(answers) / elapsed},
            "notes": [f"seconds a call: {took}"]}


def flops_per_unit(run) -> int:
    return serve.flops_per_face(run)


check = serve.check
control = serve.control
