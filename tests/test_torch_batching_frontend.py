"""Port's BatchingFrontend (eval/serving.py): the JAX package's frontend
cases (tests/test_batching_frontend.py) on a stub service, the collector's
abnormal exit, which fails every waiter, and a real CPU service whose
results equal `remove_shadows`'."""

import threading
import time

import numpy as np
import pytest
import torch

from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.eval.serving import (
    BatchingFrontend,
    ShadowRemovalService,
)
from blindshadowremoval_tpu_torch.geometry.landmarks import LM_REF


class _StubService:
    """The frontend's service protocol (preprocess / stage /
    forward_staged); records each forward's batch size."""

    def __init__(self, delay: float = 0.0, fail: bool = False,
                 preprocess_fail_on: int = -1, batch_size_fails_after=None):
        self.calls = []
        self.delay = delay
        self.fail = fail
        self.preprocess_fail_on = preprocess_fail_on
        self._preprocessed = 0
        self._bs_reads = 0
        self._bs_fails_after = batch_size_fails_after
        self.gate = threading.Event()   # set() lets forwards proceed
        self.gate.set()

    @property
    def batch_size(self):
        # the collector reads it outside the per-request handling: a fault
        # here is an abnormal exit of the collector
        self._bs_reads += 1
        if (self._bs_fails_after is not None
                and self._bs_reads > self._bs_fails_after):
            raise KeyError("collector bug")
        return 4

    def preprocess(self, image, landmarks):
        i = self._preprocessed
        self._preprocessed += 1
        if i == self.preprocess_fail_on:
            raise ValueError(f"bad request {i}")
        return {"img": image, "idx": i}

    def stage(self, chunk):
        return tuple(v["idx"] for v in chunk)

    def forward_staged(self, staged, chunk):
        self.gate.wait(timeout=2.0)
        if self.fail:
            raise RuntimeError("device fell over")
        if self.delay:
            time.sleep(self.delay)
        self.calls.append(len(chunk))
        return [{"pred": np.float32(i)} for i in staged]


def _req():
    return np.zeros((4, 4, 3), np.float32), np.zeros((68, 2), np.float32)


def _threads_end(fe):
    fe._thread.join(timeout=10.0)
    fe._dispatcher.join(timeout=10.0)
    return not fe._thread.is_alive() and not fe._dispatcher.is_alive()


def test_coalesces_up_to_max_batch():
    svc = _StubService()
    svc.gate.clear()                    # hold the device call...
    fe = BatchingFrontend(svc, max_delay_ms=250.0)
    futs = [fe.submit(*_req()) for _ in range(8)]
    svc.gate.set()                      # ...so all 8 queue before dispatch
    for f in futs:
        assert "pred" in f.result(timeout=10.0)
    fe.close()
    assert svc.calls == [4, 4]
    assert fe.batches_dispatched == 2 and fe.requests_served == 8
    assert _threads_end(fe)


def test_partial_batch_dispatches_at_deadline():
    svc = _StubService()
    fe = BatchingFrontend(svc, max_delay_ms=30.0)
    t0 = time.monotonic()
    fut = fe.submit(*_req())
    assert "pred" in fut.result(timeout=10.0)
    elapsed = time.monotonic() - t0
    fe.close()
    assert svc.calls == [1]
    assert elapsed < 5.0


def test_service_error_reaches_every_future():
    svc = _StubService(fail=True)
    fe = BatchingFrontend(svc, max_delay_ms=10.0)
    futs = [fe.submit(*_req()) for _ in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device fell over"):
            f.result(timeout=10.0)
    fe.close()


def test_close_flush_serves_queued_then_rejects():
    svc = _StubService()
    fe = BatchingFrontend(svc, max_delay_ms=5.0)
    futs = [fe.submit(*_req()) for _ in range(5)]
    fe.close()                          # flush=True by default
    assert all("pred" in f.result(timeout=10.0) for f in futs)
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(*_req())
    assert _threads_end(fe)


def test_close_noflush_cancels_pending():
    svc = _StubService()
    svc.gate.clear()                    # wedge the dispatcher's forward
    fe = BatchingFrontend(svc, max_delay_ms=5.0)
    # the depth-1 pipeline holds three batches of 4 (in the forward, in
    # the staged slot, in the blocked collector); the rest stays queued
    futs = [fe.submit(*_req()) for _ in range(20)]
    time.sleep(0.4)
    threading.Timer(0.5, svc.gate.set).start()     # while close() waits
    fe.close(flush=False)
    assert sum(1 for f in futs if f.cancelled()) >= 1
    fe.close()                          # idempotent
    assert _threads_end(fe)


def test_context_manager():
    svc = _StubService()
    with BatchingFrontend(svc, max_delay_ms=5.0) as fe:
        assert "pred" in fe.submit(*_req()).result(timeout=10.0)
    with pytest.raises(RuntimeError):
        fe.submit(*_req())


def test_bad_request_fails_only_its_own_future():
    svc = _StubService(preprocess_fail_on=1)
    svc.gate.clear()
    fe = BatchingFrontend(svc, max_delay_ms=250.0)
    futs = [fe.submit(*_req()) for _ in range(4)]
    svc.gate.set()
    with pytest.raises(ValueError, match="bad request 1"):
        futs[1].result(timeout=10.0)
    for i in (0, 2, 3):
        assert "pred" in futs[i].result(timeout=10.0)
    fe.close()
    assert svc.calls == [3]


# the collector re-raises its error after failing the futures: the thread's
# unhandled exception is this test's subject
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_collector_fault_fails_every_waiter_and_closes():
    """The collector dies outside the per-request handling while it holds
    a batch and more requests wait in the queue: every one of those futures
    fails with the collector's error (none hangs), later submits raise, and
    both threads end.  The first batch, dispatched before, is served."""
    svc = _StubService(batch_size_fails_after=1)   # batch one's read
    svc.gate.clear()
    # the collector closes a full batch at once, so a long delay makes
    # batch one exactly the four first submits however slow the machine
    fe = BatchingFrontend(svc, max_batch=4, max_delay_ms=5000.0)
    first = [fe.submit(*_req()) for _ in range(4)]
    time.sleep(0.3)               # batch one staged, its forward held
    rest = [fe.submit(*_req()) for _ in range(9)]
    svc.gate.set()
    for f in first:
        assert "pred" in f.result(timeout=10.0)
    for f in rest:
        with pytest.raises(KeyError, match="collector bug"):
            f.result(timeout=10.0)
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(*_req())
    assert _threads_end(fe)
    fe.close()                    # still safe
    assert svc.calls == [4]


S = 64


@pytest.fixture(scope="module")
def service():
    return ShadowRemovalService(
        get_config(img_size=S, compute_dtype="float32", n_res=2), None,
        batch_size=4, device="cpu")


def test_frontend_results_equal_remove_shadows(service):
    """Ten requests from two client threads through a real CPU service:
    each future's result equals the batch call's, whatever batches the
    frontend formed."""
    rng = np.random.default_rng(0)
    images = [rng.uniform(size=(120, 110, 3)).astype(np.float32)
              for _ in range(10)]
    lms = [(LM_REF * rng.uniform(60, 70) + 20
            + rng.normal(scale=0.5, size=(68, 2))).astype(np.float32)
           for _ in range(10)]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        want = service.remove_shadows(images, lms)
        futs = [None] * 10
        with BatchingFrontend(service, max_delay_ms=20.0) as fe:
            def client(idx):
                for i in idx:
                    futs[i] = fe.submit(images[i], lms[i])
            clients = [threading.Thread(target=client, args=(range(k, 10, 2),))
                       for k in range(2)]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
            got = [f.result(timeout=60.0) for f in futs]
        assert fe.requests_served == 10 and fe.batches_dispatched >= 3
    finally:
        torch.set_num_threads(threads)
    for g, w in zip(got, want):
        # the generator's batch elements are independent in eval mode;
        # oneDNN may block a batch of 1-4 differently: float noise only
        np.testing.assert_allclose(g["pred"], w["pred"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["mask_pred"], w["mask_pred"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(g["box"], w["box"])
