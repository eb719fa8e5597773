"""The port's trace exports and the cluster's merged metrics against the
JAX package's (mirrors the export and cluster legs of
``tests/test_obs.py``).

``repro_torch.obs.export`` is a copy of ``repro.obs.export``: on the same
recorder events and registry it must give the same Prometheus text,
Chrome/Perfetto document and queue-depth timeline.  Through the port's
cluster, the merged latency histograms reconcile exactly with the merged
``ExecutorStats`` across a replica's death and resurrection, with the
JAX cluster's request totals; and two runs on a ``VirtualClock`` export
byte-identical traces.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import OracleLLM as JaxOracle
from repro.core import block_join as jax_block_join
from repro.core.oracle import VirtualClock as JaxVirtualClock
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro.obs import TraceRecorder as JaxTraceRecorder
from repro.obs import chrome_trace_json as jax_chrome_trace_json
from repro.obs import prometheus_text as jax_prometheus_text
from repro.obs import queue_depth_timeline as jax_queue_depth_timeline
from repro.obs import write_chrome_trace as jax_write_chrome_trace
from repro.serve import Cluster as JaxCluster
from repro.serve import ClusterClient as JaxClusterClient
from repro.serve import ContinuousBatchingExecutor as JaxExecutor
from repro.serve import Engine as JaxEngine
from repro.serve import make_router as jax_make_router
from repro_torch.configs import get_smoke_config
from repro_torch.core import OracleLLM, block_join
from repro_torch.core.oracle import VirtualClock
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import from_numpy
from repro_torch.obs import (
    MetricsRegistry,
    TraceRecorder,
    chrome_trace_json,
    prometheus_text,
    queue_depth_timeline,
    write_chrome_trace,
)
from repro_torch.obs.export import CLUSTER_PID
from repro_torch.serve import (
    Cluster,
    ClusterClient,
    ContinuousBatchingExecutor,
    Engine,
    make_router,
)

WAIT_S = 120.0   # every wait on a port cluster


def make_tables(n1=8, n2=16):
    colours = ["red", "blue"]
    left = [f"item {i} in {colours[i % 2]}" for i in range(n1)]
    right = [f"want {k} {colours[k % 2]}" for k in range(n2)]
    pred = lambda a, b: a.split()[-1] == b.split()[-1]  # noqa: E731
    truth = {(i, k) for i, a in enumerate(left)
             for k, b in enumerate(right) if pred(a, b)}
    return left, right, pred, truth


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke_config("granite-3-2b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(7),
                              jnp.float32)
    return cfg, jparams, from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


# ---------------------------------------------------------------------------
# exports on the same events and registry
# ---------------------------------------------------------------------------


def _registry(cls):
    r = cls()
    r.counter("reqs").inc(2)
    r.gauge("depth").set(4)
    r.histogram("lat").record(0.01)
    return r


def test_prometheus_text_renders_all_kinds():
    text = prometheus_text(_registry(MetricsRegistry))
    assert "repro_reqs_total 2" in text
    assert "repro_depth 4" in text
    assert "repro_depth_peak 4" in text
    assert 'repro_lat_bucket{le="+Inf"} 1' in text
    assert "repro_lat_count 1" in text
    assert text == jax_prometheus_text(_registry(JaxMetricsRegistry))


def _recorded(recorder_cls, clock_cls):
    rec = recorder_cls(clock=clock_cls())
    rec.instant("submit", "request", request=1)
    t0 = rec.now()
    rec.complete("prefill", "executor", t0, rows=2)
    rec.counter("queue_depth", 3)
    return rec


def test_chrome_trace_shapes(tmp_path):
    rec = _recorded(TraceRecorder, VirtualClock)
    doc = chrome_trace_json(rec.events(), pid_names={0: "exec"})
    evs = doc["traceEvents"]
    metas = [e for e in evs if e["ph"] == "M"]
    assert metas and metas[0]["args"]["name"] == "exec"
    inst = next(e for e in evs if e["ph"] == "i")
    assert inst["s"] == "t" and inst["args"]["request"] == 1
    span = next(e for e in evs if e["ph"] == "X")
    assert "dur" in span
    ctr = next(e for e in evs if e["ph"] == "C")
    assert ctr["args"] == {"queue_depth": 3}
    jrec = _recorded(JaxTraceRecorder, JaxVirtualClock)
    assert doc == jax_chrome_trace_json(jrec.events(), pid_names={0: "exec"})
    path, jpath = tmp_path / "t.json", tmp_path / "j.json"
    assert write_chrome_trace(str(path), rec) == 3
    assert jax_write_chrome_trace(str(jpath), jrec) == 3
    with open(path, "rb") as f, open(jpath, "rb") as g:
        text = f.read()
        assert text == g.read()
    json.loads(text)   # well-formed


def test_queue_depth_timeline_downsamples():
    pts = {}
    for name, recorder_cls, clock_cls, timeline in (
            ("port", TraceRecorder, VirtualClock, queue_depth_timeline),
            ("jax", JaxTraceRecorder, JaxVirtualClock,
             jax_queue_depth_timeline)):
        rec = recorder_cls(clock=clock_cls())
        for i in range(1000):
            rec.counter("queue_depth", i % 7)
            rec.instant("noise", "x")
        pts[name] = timeline(rec.events(), max_points=50)
    assert len(pts["port"]) == 50
    assert all(0 <= v <= 6 for _, v in pts["port"])
    assert pts["port"] == pts["jax"]


# ---------------------------------------------------------------------------
# conservation across a replica's incarnations
# ---------------------------------------------------------------------------


def _two_incarnations(cl, client_cls, oracle_cls, join, trace):
    """A held block join, a replica's death and resurrection, another
    held join: ``(pairs, requests_finished, ttft counts, names)``."""
    left, right, pred, truth = make_tables()
    client = client_cls(cl, oracle=oracle_cls(pred, context_limit=512))
    cl.hold()
    r1 = join(left, right, "the colours match", client, 4, 2)
    cl.drain()
    before = cl.metrics()
    stats_before = cl.stats()
    assert before.get("ttft_s").count == stats_before.requests_finished
    cl.fail_replica(1)
    deadline = time.time() + 60
    while cl.replicas_alive == 2 and time.time() < deadline:
        time.sleep(0.01)
    assert cl.replicas_alive == 1
    assert cl.check_health() == 1
    cl.hold()
    r2 = join(left, right, "the colours match", client, 4, 2)
    cl.drain()
    merged, stats = cl.metrics(), cl.stats()
    ttft, score = merged.get("ttft_s"), merged.get("score_e2e_s")
    score_n = score.count if score is not None else 0
    assert ttft.count + score_n == stats.requests_finished
    assert ttft.count > before.get("ttft_s").count
    summ = cl.summary()
    assert summ["metrics"]["histograms"]["ttft_s"]["count"] == ttft.count
    assert summ["trace"]["events"] == len(trace)
    return ((r1.pairs, r2.pairs), stats.requests_finished,
            (before.get("ttft_s").count, ttft.count),
            {e[1] for e in trace.events()}, truth)


def test_cluster_conservation_across_incarnations(weights):
    """Kill a replica, resurrect it, run again: the merged histograms
    reconcile with the merged stats, with the JAX cluster's totals."""
    cfg, jparams, tparams = weights
    tcfg = get_smoke_config("granite-3-2b")
    trace, jtrace = TraceRecorder(), JaxTraceRecorder()
    with Cluster.replicate(tcfg, tparams, ByteTokenizer(tcfg.vocab_size), 2,
                           router=make_router("round_robin"), max_seq=512,
                           slots=4, trace=trace,
                           wait_timeout_s=WAIT_S) as cl:
        got = _two_incarnations(cl, ClusterClient, OracleLLM, block_join,
                                trace)
        pids = {e[5] for e in trace.events()}
    with JaxCluster.replicate(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                              2, router=jax_make_router("round_robin"),
                              max_seq=512, slots=4, trace=jtrace) as jcl:
        want = _two_incarnations(jcl, JaxClusterClient, JaxOracle,
                                 jax_block_join, jtrace)
    pairs, finished, ttft, names, truth = got
    assert pairs == (truth, truth)
    assert {"route", "resurrect"} <= names
    assert {0, 1, CLUSTER_PID} <= pids   # replicas and the cluster scope
    assert (pairs, finished, ttft, names) == want[:4]


# ---------------------------------------------------------------------------
# deterministic replay: two VirtualClock runs -> byte-identical export
# ---------------------------------------------------------------------------


def _virtual_run(engine, executor_cls, clock, recorder, path=None):
    ex = executor_cls(engine, clock=clock, trace=recorder)
    assert recorder.clock is clock
    handles = [ex.submit(f"Text: colour probe {i}\nAnswer:", max_tokens=6)
               for i in range(6)]
    for _ in ex.as_completed(handles):
        pass
    if path is not None:
        write_chrome_trace(path, recorder)
    return [h.result.text for h in handles]


def test_virtualclock_trace_replay_byte_identical(weights, tmp_path,
                                                  monkeypatch):
    """Greedy decoding (no oracle) on a VirtualClock: two port runs
    export byte-identical traces, and decode the JAX engine's texts."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    cfg, jparams, tparams = weights
    tcfg = get_smoke_config("granite-3-2b")
    paths = [str(tmp_path / "a.json"), str(tmp_path / "b.json")]
    texts = [_virtual_run(Engine(tcfg, tparams, ByteTokenizer(tcfg.vocab_size),
                                 max_seq=512, slots=4, prefix_cache=True),
                          ContinuousBatchingExecutor, VirtualClock(),
                          TraceRecorder(), p) for p in paths]
    assert texts[0] == texts[1]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        b1, b2 = a.read(), b.read()
    assert b1 == b2 and len(b1) > 100
    jtexts = _virtual_run(JaxEngine(cfg, jparams,
                                    JaxByteTokenizer(cfg.vocab_size),
                                    max_seq=512, slots=4, prefix_cache=True),
                          JaxExecutor, JaxVirtualClock(), JaxTraceRecorder())
    assert texts[0] == jtexts
