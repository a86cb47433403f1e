"""The port's asynchronous serving front end (`AsyncLocalizer`, `ServingStats`,
`_Pending` in inference.py) and the dispatch / collect pipeline under it, on
the CPU: the cases of tests/test_serving_pipeline.py and of
tests/test_inference.py::test_async_localizer, with the port's answers held to
the JAX `AsyncLocalizer`'s on the same requests and weights (same moments,
scores within 1e-5), plus a submit racing close, close with work queued, and
max_in_flight=1 under a burst. Every wait has a timeout, so a hang fails
instead of stalling the suite."""

import sys
import threading
import time

import jax
import numpy as np
import pytest

from video_moment_localization_tpu.config import ModelConfig as JaxModelConfig
from video_moment_localization_tpu.data.synthetic import synthetic_embedding as jax_embedding
from video_moment_localization_tpu.inference import AsyncLocalizer as JaxAsync
from video_moment_localization_tpu.inference import MomentLocalizer as JaxLocalizer
from video_moment_localization_tpu.models import init_smin_params
from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.data.synthetic import synthetic_embedding
from video_moment_localization_tpu_torch.inference import (
    AsyncLocalizer,
    MomentLocalizer,
    ServingStats,
    _Pending,
)
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.models.smin import SMIN

SHAPE = dict(T=8, L=4, C=2, D=32, dl=16, num_smi_layers=1, input_video_dim=12,
             max_query_length=5, lstm_hidden_size=16, word_dim=300)
SCORE_TOL = 1e-5
WAIT = 120          # seconds any one future or join may take


@pytest.fixture(scope="module")
def pair():
    """(port localizer, JAX localizer) over the same weights and embedding."""
    params = init_smin_params(jax.random.PRNGKey(0), JaxModelConfig(**SHAPE))
    model = SMIN(ModelConfig(**SHAPE))
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)),
                          strict=True)
    port = MomentLocalizer(ModelConfig(**SHAPE), model, synthetic_embedding(dim=300, seed=0),
                           serve_batch=4, device="cpu")
    ref = JaxLocalizer(JaxModelConfig(**SHAPE), params, jax_embedding(dim=300, seed=0),
                       serve_batch=4)
    return port, ref


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((int(rng.integers(4, 12)), 12)).astype(np.float32),
             "person opens the door", 10.0 + i) for i in range(n)]


def _assert_same(got, want, exact_scores=False):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [(m.start, m.end) for m in a] == [(m.start, m.end) for m in b]
        if exact_scores:
            assert [m.score for m in a] == [m.score for m in b]
        else:
            np.testing.assert_allclose([m.score for m in a], [m.score for m in b], rtol=0,
                                       atol=SCORE_TOL)


def _join_all(server):
    """close() with a deadline: the two threads must have ended."""
    closer = threading.Thread(target=server.close, daemon=True)
    closer.start()
    closer.join(WAIT)
    assert not closer.is_alive(), "close() did not return"
    assert not server._batcher.is_alive() and not server._completer.is_alive()


def test_pipelined_batches_match_sequential(pair):
    port, ref = pair
    reqs = _requests(10)
    piped = port.localize_batch(reqs, top_k=3, max_in_flight=2)
    _assert_same(piped, port.localize_batch(reqs, top_k=3, max_in_flight=0), exact_scores=True)
    _assert_same(piped, ref.localize_batch(reqs, top_k=3, max_in_flight=2))
    for req, got in zip(reqs[:3], piped[:3]):
        _assert_same([port.localize(req[0], req[1], req[2], top_k=3)], [got])


def test_dispatch_collect_roundtrip(pair):
    port, ref = pair
    reqs = _requests(3, seed=1)
    h1 = port.dispatch(reqs[:2], top_k=2)
    h2 = port.dispatch(reqs[2:], top_k=2)          # two in flight
    r1, r2 = port.collect(h1), port.collect(h2)
    assert len(r1) == 2 and len(r2) == 1 and all(len(m) == 2 for m in r1 + r2)
    for m in r1[0]:
        assert 0.0 <= m.start < m.end <= reqs[0][2] + 1e-6
    _assert_same(r1 + r2, ref.localize_batch(reqs, top_k=2))


def test_async_two_stage_results_and_stats(pair):
    port, ref = pair
    reqs = _requests(13, seed=2)
    with JaxAsync(ref, top_k=3, max_wait_ms=5.0, max_in_flight=2) as jserver:
        want = [f.result(timeout=WAIT) for f in [jserver.submit(*r) for r in reqs]]
    with AsyncLocalizer(port, top_k=3, max_wait_ms=5.0, max_in_flight=2) as server:
        got = [f.result(timeout=WAIT) for f in [server.submit(*r) for r in reqs]]
    _assert_same(got, want)
    _assert_same(got, port.localize_batch(reqs, top_k=3))
    stats = server.stats.snapshot()
    assert set(stats) == set(jserver.stats.snapshot())
    assert stats["count"] == len(reqs) and stats["errors"] == 0
    assert stats["p50_ms"] > 0 and stats["p99_ms"] >= stats["p50_ms"]
    assert stats["max_ms"] >= stats["p99_ms"] and stats["mean_ms"] > 0
    assert stats["mean_batch"] >= 1.0 and stats["throughput_rps"] > 0
    assert 1 <= stats["max_queue_depth"] <= len(reqs)


def test_async_error_propagates_and_counts(pair):
    port, _ = pair
    with AsyncLocalizer(port, top_k=3, max_wait_ms=1.0) as server:
        bad = server.submit(np.zeros((3,), np.float32), "query", 5.0)
        with pytest.raises(Exception):
            bad.result(timeout=WAIT)
        ok = server.submit(np.random.default_rng(0).standard_normal((6, 12)).astype(np.float32),
                           "person walks", 8.0)
        assert len(ok.result(timeout=WAIT)) == 3      # the server keeps serving
    stats = server.stats.snapshot()
    assert stats["errors"] >= 1 and stats["count"] >= 2


def test_async_malformed_request_fails_its_own_future_only(pair):
    """A malformed request in the middle of a burst fails its own future
    (one error), and every other request of its group and the others is
    answered as by `localize_batch`."""
    port, _ = pair
    reqs = _requests(8, seed=4)
    with AsyncLocalizer(port, top_k=2, max_wait_ms=50.0, max_in_flight=2) as server:
        first = [server.submit(*r) for r in reqs[:3]]
        bad = server.submit(np.zeros((3,), np.float32), "query", 5.0)
        later = [server.submit(*r) for r in reqs[3:]]
        with pytest.raises(ValueError):
            bad.result(timeout=WAIT)
        got = [f.result(timeout=WAIT) for f in first + later]
    _assert_same(got, port.localize_batch(reqs, top_k=2))
    stats = server.stats.snapshot()
    assert stats["errors"] == 1 and stats["count"] == len(reqs) + 1


def test_async_backpressure_bounded_inflight(pair):
    """max_in_flight=1 under a burst completes (the bounded queue never
    deadlocks the batcher / completer pair) with the batch answers."""
    port, _ = pair
    reqs = _requests(9, seed=3)
    with AsyncLocalizer(port, top_k=2, max_wait_ms=0.5, max_in_flight=1) as server:
        results = [f.result(timeout=WAIT) for f in [server.submit(*r) for r in reqs]]
    _assert_same(results, port.localize_batch(reqs, top_k=2))


def test_async_localizer_matches_jax_and_rejects_after_close(pair):
    """tests/test_inference.py::test_async_localizer on the port, held to the
    JAX server's answers, and its closed-server check."""
    port, ref = pair
    rng = np.random.default_rng(3)
    reqs = [(rng.standard_normal((int(n), 12)).astype(np.float32), "person sits down",
             float(n)) for n in (10, 20, 33, 17, 26)]
    with JaxAsync(ref, top_k=3, max_wait_ms=20.0) as jserver:
        want = [f.result(timeout=WAIT) for f in [jserver.submit(*r) for r in reqs]]
    with AsyncLocalizer(port, top_k=3, max_wait_ms=20.0) as server:
        got = [f.result(timeout=WAIT) for f in [server.submit(*r) for r in reqs]]
    _assert_same(got, want)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(*reqs[0])


def test_close_with_work_queued_resolves_everything(pair):
    port, _ = pair
    reqs = _requests(12, seed=5)
    server = AsyncLocalizer(port, top_k=2, max_wait_ms=50.0, max_in_flight=1)
    futures = [server.submit(*r) for r in reqs]
    _join_all(server)                              # straight away, work still queued
    assert all(f.done() for f in futures)
    _assert_same([f.result(timeout=0) for f in futures], port.localize_batch(reqs, top_k=2))
    assert server.stats.snapshot()["count"] == len(reqs)


def test_submit_racing_close(pair):
    """Submitters race close() under a short switch interval: every submit
    either raises "closed" or returns a future that resolves; none hangs."""
    port, _ = pair
    reqs = _requests(4, seed=6)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for trial in range(3):
            server = AsyncLocalizer(port, top_k=2, max_wait_ms=0.2, max_in_flight=2)
            accepted, refused = [], []
            lock = threading.Lock()

            def submitter(k):
                for i in range(6):
                    try:
                        f = server.submit(*reqs[(k + i) % len(reqs)])
                    except RuntimeError as e:
                        assert "closed" in str(e)
                        with lock:
                            refused.append(1)
                        return
                    with lock:
                        accepted.append(f)

            threads = [threading.Thread(target=submitter, args=(k,), daemon=True)
                       for k in range(6)]
            for t in threads:
                t.start()
            time.sleep(0.002 * trial)
            _join_all(server)
            for t in threads:
                t.join(WAIT)
                assert not t.is_alive()
            for f in accepted:
                assert len(f.result(timeout=WAIT)) == 2
            assert server.stats.snapshot()["count"] == len(accepted)
    finally:
        sys.setswitchinterval(old)


def test_video_key_takes_the_grouped_path(pair):
    """Requests submitted with a video_key share a featurization and encode
    (the grouped path) and answer as the same requests without a key."""
    port, _ = pair
    rng = np.random.default_rng(8)
    vids = [rng.standard_normal((int(n), 12)).astype(np.float32) for n in (7, 11)]
    queries = ["person opens the door", "person sits down"]
    reqs = [(v, q, 9.0) for v in vids for q in queries]
    with AsyncLocalizer(port, top_k=3, max_wait_ms=50.0) as server:
        keyed = [server.submit(v, q, d, video_key=k)
                 for k, (v, q, d) in zip((0, 0, 1, 1), reqs)]
        got = [f.result(timeout=WAIT) for f in keyed]
    _assert_same(got, port.localize_batch([(v.copy(), q, d) for v, q, d in reqs], top_k=3))


def test_serving_stats_window():
    s = ServingStats(window=4)
    for i in range(10):
        s.record_done(0.001 * (i + 1))
    snap = s.snapshot()
    assert snap["count"] == 10
    assert snap["mean_ms"] == pytest.approx(8.5, rel=1e-6)   # the last 4: 7..10 ms
    assert snap["max_ms"] == pytest.approx(10.0, rel=1e-6)
    assert ServingStats().snapshot().keys() == {"count", "errors", "throughput_rps",
                                                "mean_batch", "max_queue_depth"}


def test_pending_carries_request_future_and_time():
    from concurrent.futures import Future

    p = _Pending((np.zeros((2, 12), np.float32), "q", 1.0), Future(), 3.5)
    assert p.t_submit == 3.5 and not p.future.done() and p.request[1] == "q"
