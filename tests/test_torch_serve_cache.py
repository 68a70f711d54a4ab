"""The port's serving caches and trace spans against the JAX package's.

- ``content_key`` / ``row_key`` equal to JAX's;
- ``ByteBudgetLRU`` and ``ChunkResultCache`` driven by one seeded sequence
  of puts, gets and flight operations in both packages: every return
  value, the eviction order (the surviving keys in recency order), the
  byte count and every stat equal;
- ``params_fingerprint`` over the port's named tensors: equal for the same
  weights loaded twice, different when one weight differs, bf16 included;
- a tiny QA model (2 layers, hidden 32, ``hidden_dropout_prob`` 0) in both
  packages, its JAX params through ``models/convert.py``
  ``from_jax_params``; both engines with both caches on at small budgets
  (so both tiers evict) answer one serial request sequence (cold, hot,
  partially hot, evicted). Every response agrees (the score within
  ``tests/test_torch_serve.py``'s tolerance) and after every request the
  two tiers' hits, misses, evictions, bytes and entries, the flight joins
  and the device-batch count are equal;
- the engine behaviours the JAX package pins: a hot request launches no
  batch, a fully-hot request is served with the queue full and past its
  capacity, a cold one past it is refused with its flights rolled back;
  and under 16 concurrent threads every answer equals the uncached one and
  no flight is left behind;
- the span names per request id of both packages' tracers, through both
  HTTP servers with the same forwarded ``X-Request-Id``s.
"""

import json
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from ml_recipe_tpu.metrics import trace as jax_trace
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh
from ml_recipe_tpu.serve import cache as jax_cache
from ml_recipe_tpu.serve.bucketing import BucketGrid as JaxBucketGrid
from ml_recipe_tpu_torch.metrics import trace
from ml_recipe_tpu_torch.models import EncoderConfig, QAModel, from_jax_params
from ml_recipe_tpu_torch.serve import cache
from ml_recipe_tpu_torch.serve.batcher import QueueFullError
from ml_recipe_tpu_torch.serve.bucketing import BucketGrid
from ml_recipe_tpu_torch.tokenizer import Tokenizer

from helpers import write_vocab

# f32 forward on both sides (tests/test_torch_serve.py's tolerance)
SCORE_ATOL = 1e-4
# budgets small enough that both tiers evict within the sequence: a chunk
# row costs 96 + 61 + 48 = 205 B, so tier 2 holds 6 rows
CHUNK_BUDGET = 6 * 205
DOC_BUDGET = 12_000

_DOCS = [
    "<P> London is the capital of England . </P> <P> Big Ben was built in "
    "the city . The river Thames runs through London . </P> <P> The city is "
    "the biggest city of England . </P>",
    "<P> The quick brown fox jumps over the lazy dog . </P> <P> The dog was "
    "lazy and the fox was quick . </P>",
    "<P> England is the country of the city of London . People like the "
    "river and the big city . </P> <P> The capital is big and the river "
    "runs through the capital . </P> <P> The tower is in London . </P>",
    "<P> The river runs through the city . </P>",
]
_QUESTIONS = ["what is the capital of england ?", "what runs through london ?"]
# cold, hot, partially hot (a grown document), then back to evicted rows
_SEQUENCE = (
    [(q, d) for d in _DOCS[:2] for q in _QUESTIONS]
    + [(_QUESTIONS[0], _DOCS[0]), (_QUESTIONS[1], _DOCS[1])]
    + [(_QUESTIONS[0], _DOCS[0] + " <P> London is big . </P>")]
    + [(q, d) for d in _DOCS[2:] for q in _QUESTIONS]
    + [(_QUESTIONS[0], _DOCS[0]), (_QUESTIONS[1], _DOCS[3]),
       (_QUESTIONS[1], _DOCS[3])]
)


# -- keys ----------------------------------------------------------------------


@pytest.mark.parametrize("text", [
    "", "London is the capital of England .", "naïve café ☕ 東京",
    "\ud800 a lone surrogate", "x" * 10_000])
def test_content_key_equals_jax(text):
    assert cache.content_key(text) == jax_cache.content_key(text)


@pytest.mark.parametrize("precision", ["off", "int8", "", None])
def test_row_key_equals_jax(precision):
    rng = np.random.default_rng(0)
    for n in (1, 7, 64, 384):
        row = rng.integers(0, 30522, n).tolist()
        assert cache.row_key("f" * 24, precision, row) == \
            jax_cache.row_key("f" * 24, precision, row)
        assert cache.row_key("f" * 24, precision, np.asarray(row)) == \
            cache.row_key("f" * 24, precision, row)


# -- the LRU and the flight table ----------------------------------------------


def _lru_trace(module, cls, seed):
    """Every observable of one seeded sequence of puts and gets."""
    rng = np.random.default_rng(seed)
    lru = getattr(module, cls)(1000)
    out = []
    for _ in range(400):
        key = f"k{int(rng.integers(0, 30))}"
        if rng.random() < 0.55:
            cost = int(rng.integers(20, 260)) if rng.random() < 0.97 else 1001
            out.append(("put", key, lru.put(key, key.upper(), cost)))
        else:
            out.append(("get", key, lru.get(key)))
        out.append((lru.bytes, len(lru), tuple(lru._entries)))
    out.append(lru.stats())
    return out


@pytest.mark.parametrize("cls", ["ByteBudgetLRU", "ChunkResultCache"])
@pytest.mark.parametrize("seed", [0, 1])
def test_lru_sequence_equals_jax(cls, seed):
    got = _lru_trace(cache, cls, seed)
    assert got == _lru_trace(jax_cache, cls, seed)
    assert got[-1]["evictions"] > 0 and got[-1]["hits"] > 0


def _flight_trace(module):
    c = module.ChunkResultCache(1000)
    a, b = object(), object()
    out = [c.join_flight("r1", (a, 0)), c.join_flight("r1", (b, 1)),
           c.join_flight("r2", (a, 1)), c.join_flight("r2", (b, 0)),
           c.join_flight("r3", (b, 2)), c.join_flight("r3", (a, 2)),
           c.inflight()]
    waiters, evicted = c.complete("r1", {"scores": 1.0}, 300)
    out += [[i for _, i in waiters], evicted, c.get("r1")]
    out += [c.remove_waiters(a), [i for _, i in c.fail_flight("r2")]]
    c.abort_flight("r3")
    out += [c.inflight(), c.flight_joins, c.flight_join_rollbacks,
            c.join_flight("r1", (a, 3)), c.stats()]
    return out


def test_single_flight_operations_equal_jax():
    assert _flight_trace(cache) == _flight_trace(jax_cache)


# -- the weights fingerprint -----------------------------------------------------


def _tiny_kw(vocab_size):
    return dict(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                num_heads=2, intermediate_size=64, max_position_embeddings=66,
                num_labels=5, hidden_dropout_prob=0.0)


def test_params_fingerprint_same_weights_equal_one_weight_differs():
    kw = _tiny_kw(50)
    jmodel = JaxQAModel(JaxEncoderConfig(**kw))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(3), np.zeros((1, 8), np.int32))["params"])
    models = []
    for _ in range(2):
        m = QAModel(EncoderConfig(**kw), device="cpu")
        m.load_state_dict(from_jax_params(params))
        models.append(m)
    fp = cache.params_fingerprint(models[0])
    assert len(fp) == 24 and fp == cache.params_fingerprint(models[1])
    with torch.no_grad():
        next(models[1].parameters()).view(-1)[5] += 1e-3
    assert cache.params_fingerprint(models[1]) != fp
    # bf16 tensors hash through their bits
    bf16 = {k: v.to(torch.bfloat16) for k, v in models[0].state_dict().items()}
    assert cache.params_fingerprint(bf16) not in (fp, None)
    assert cache.params_fingerprint(bf16) == cache.params_fingerprint(
        {k: v.clone() for k, v in bf16.items()})


def test_params_fingerprint_samples_large_tensors_head_and_tail():
    big = torch.arange(3 << 20, dtype=torch.int8).reshape(3, -1)  # 3 MiB
    fp = cache.params_fingerprint({"w": big})
    middle = big.clone()
    middle.view(-1)[len(middle.view(-1)) // 2] += 1
    assert cache.params_fingerprint({"w": middle}) == fp
    for i in (0, -1):
        edge = big.clone()
        edge.view(-1)[i] += 1
        assert cache.params_fingerprint({"w": edge}) != fp
    assert cache.params_fingerprint({"w": big.reshape(-1)}) != fp  # shape


# -- the engines ------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from ml_recipe_tpu.serve.engine import QAEngine as JaxQAEngine
    from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
    from ml_recipe_tpu_torch.serve.engine import QAEngine

    vocab = str(write_vocab(tmp_path_factory.mktemp("torch_serve_cache")))
    jtok = JaxTokenizer("bert", vocab, lowercase=True)
    tok = Tokenizer("bert", vocab, lowercase=True)
    kw = _tiny_kw(len(tok))
    jmodel = JaxQAModel(JaxEncoderConfig(**kw))
    params = jmodel.init(jax.random.key(0),
                         np.zeros((1, 8), np.int32))["params"]
    model = QAModel(EncoderConfig(**kw), device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    common = dict(max_batch_delay_ms=5, queue_size=64, max_question_len=16,
                  doc_stride=24)
    caches = dict(serve_cache_bytes=CHUNK_BUDGET, doc_cache_bytes=DOC_BUDGET)

    def make(**extra):
        return QAEngine(model, tok, grid=BucketGrid.from_spec("4x64,8x64"),
                        **{**common, **extra})

    jengine = JaxQAEngine(jmodel, params, jtok,
                          grid=JaxBucketGrid.from_spec("4x64,8x64"),
                          mesh=build_mesh(), **common, **caches)
    jengine.warmup(hbm_preflight=False)
    engine = make(**caches)
    engine.warmup()
    plain = make()
    plain.warmup()
    ns = SimpleNamespace(jax=jengine, port=engine, plain=plain, make=make,
                         caches=caches)
    yield ns
    for e in (jengine, engine, plain):
        e.close()


def _same(got, ref):
    assert (got.answer, got.label, got.start, got.end, got.n_chunks) == (
        ref.answer, ref.label, ref.start, ref.end, ref.n_chunks)
    assert abs(got.score - ref.score) <= SCORE_ATOL


def _counters(engine):
    stats = engine.cache_stats()
    out = {f"{tier}.{k}": stats[tier][k] for tier in ("doc", "chunk")
           for k in ("hits", "misses", "evictions", "bytes", "entries")}
    out["flight_joins"] = stats["chunk"]["flight_joins"]
    out["batches"] = engine.m_batches.value
    return out


def test_serial_sequence_equals_jax_responses_and_counters(engines):
    hot = 0
    for question, document in _SEQUENCE:
        batches = engines.port.m_batches.value
        ref = engines.jax.submit(question, document).result(timeout=60)
        got = engines.port.submit(question, document).result(timeout=60)
        _same(got, ref)
        assert _counters(engines.port) == _counters(engines.jax)
        hot += engines.port.m_batches.value == batches
    final = _counters(engines.port)
    # the sequence exercised every path it claims to
    assert final["doc.evictions"] > 0 and final["chunk.evictions"] > 0
    assert final["doc.hits"] > 0 and final["chunk.hits"] > 0 and hot >= 2
    # and the Prometheus series mirror the same numbers in both packages
    names = [f"qa_{tier}_cache_{k}" for tier in ("doc", "chunk")
             for k in ("hits_total", "misses_total", "evictions_total",
                       "bytes", "entries")] + ["qa_chunk_flight_joins_total"]
    pages = [e.render_metrics() for e in (engines.port, engines.jax)]
    for name in names:
        lines = [[ln for ln in page.splitlines()
                  if ln.split(" ")[0] == name] for page in pages]
        assert lines[0] == lines[1] and len(lines[0]) == 1, name


def test_cached_responses_equal_uncached(engines):
    for question, document in _SEQUENCE[:6]:
        ref = engines.plain.submit(question, document).result(timeout=60)
        got = engines.port.submit(question, document).result(timeout=60)
        assert got.to_json() | {"latency_ms": 0} == \
            ref.to_json() | {"latency_ms": 0}


def test_budget_zero_registers_the_series_and_touches_no_cache(engines):
    assert engines.plain._chunk_cache is None
    assert engines.plain._doc_cache is None
    assert engines.plain.cache_stats() == {"doc": None, "chunk": None}
    page = engines.plain.render_metrics()
    for name in ("qa_doc_cache_hits_total", "qa_chunk_cache_misses_total",
                 "qa_chunk_flight_joins_total",
                 "qa_kernel_build_hits_total", "qa_kernel_build_misses_total"):
        assert f"\n{name} 0\n" in page, name
    # the CPU model runs the plain attention: no kernel launched or built
    assert 'qa_kernel_launches_total{kernel="fused_attention_fwd"} 0' in page
    assert engines.plain.warmup_report["attention_route"] == "plain"


def test_fully_hot_request_needs_no_queue_slot(engines):
    from ml_recipe_tpu_torch.serve.engine import RequestRejected

    engine = engines.port
    question, document = _QUESTIONS[0], _DOCS[2]
    warm = engine.submit(question, document).result(timeout=60)
    assert warm.n_chunks >= 2
    batcher = engine.batcher
    with batcher._cv:
        real_pending, real_size = batcher._n_pending, batcher.queue_size
        batcher._n_pending = batcher.queue_size  # saturated
    try:
        batches = engine.m_batches.value
        hot = engine.submit(question, document).result(timeout=5)
        assert hot.to_json() | {"latency_ms": 0} == \
            warm.to_json() | {"latency_ms": 0}
        assert engine.m_batches.value == batches  # never reached the device
        with pytest.raises(QueueFullError):
            engine.submit(question, document + " <P> fresh text . </P>")
        with batcher._cv:
            batcher._n_pending = real_pending
            batcher.queue_size = 1  # past capacity: only hot documents pass
        engine.submit(question, document).result(timeout=5)
        with pytest.raises(RequestRejected, match="uncached windows"):
            engine.submit(question, document.replace("London", "Paris"))
        assert engine._chunk_cache.inflight() == 0  # rolled back
    finally:
        with batcher._cv:
            batcher._n_pending, batcher.queue_size = real_pending, real_size


def test_concurrent_requests_agree_and_leave_no_flight(engines):
    """16 threads, a short switch interval, every request four times at
    once: each answer equals the uncached engine's, every lookup is a hit
    or a miss, nothing stays in flight, and each distinct row is cached
    once."""
    import sys
    import threading

    engine = engines.make(serve_cache_bytes=1 << 20, doc_cache_bytes=1 << 20,
                          max_batch_delay_ms=50)
    engine.warmup()
    distinct = [(q, d) for d in _DOCS for q in _QUESTIONS]
    ref = {r: engines.plain.submit(*r).result(timeout=60).to_json()
           | {"latency_ms": 0} for r in distinct}
    work = distinct * 4
    results, start = [None] * len(work), threading.Barrier(16)

    def worker(k):
        start.wait(timeout=30)
        for i in range(k, len(work), 16):
            results[i] = engine.submit(*work[i]).result(timeout=60).to_json()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        engine.close()
    assert not any(t.is_alive() for t in threads)
    for r, got in zip(work, results):
        assert got | {"latency_ms": 0} == ref[r]
    chunk = engine.cache_stats()["chunk"]
    windows = sum(got["n_chunks"] for got in results)
    assert chunk["hits"] + chunk["misses"] == windows
    assert chunk["inflight"] == 0 and chunk["evictions"] == 0
    assert chunk["entries"] == sum(ref[r]["n_chunks"] for r in distinct)


# -- trace spans ---------------------------------------------------------------------


def _post(server, question, document, rid):
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}/v1/qa",
        data=json.dumps({"question": question,
                         "document": document}).encode("utf-8"),
        headers={"Content-Type": "application/json", "X-Request-Id": rid})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def span_names_by_request(doc) -> dict:
    """Span names per request id: ``args.request_id`` (both packages) or,
    for a batch's flush and device spans, ``args.request_ids`` (the
    port's)."""
    out = {}
    for event in doc["traceEvents"]:
        args = event.get("args", {})
        rids = args.get("request_ids") or [args.get("request_id")]
        for rid in rids:
            if rid is not None:
                out.setdefault(str(rid), set()).add(event["name"])
    return out


def test_span_names_per_request_equal_jax(engines, tmp_path):
    from ml_recipe_tpu.serve.server import QAServer as JaxQAServer
    from ml_recipe_tpu_torch.serve.server import QAServer

    # fresh cached engines, so the first request is cold in both
    from ml_recipe_tpu.serve.engine import QAEngine as JaxQAEngine

    jengine = JaxQAEngine(engines.jax.model, engines.jax.params,
                          engines.jax.tokenizer, grid=engines.jax.grid,
                          mesh=engines.jax.mesh, max_batch_delay_ms=5,
                          queue_size=64, max_question_len=16, doc_stride=24,
                          **engines.caches)
    jengine.warmup(hbm_preflight=False)
    engine = engines.make(**engines.caches)
    engine.warmup()
    tracers = [jax_trace.install(jax_trace.TraceWriter(tmp_path / "j.json")),
               trace.install(trace.TraceWriter(tmp_path / "t.json"))]
    servers = [JaxQAServer(jengine, port=0), QAServer(engine, port=0)]
    try:
        for s in servers:
            s.start()
        for server in servers:
            for i, question in enumerate([*_QUESTIONS, _QUESTIONS[0]]):
                _post(server, question, _DOCS[3], f"r-{i}")
    finally:
        jax_trace.install(None)
        trace.install(None)
        for s, e in zip(servers, (jengine, engine)):
            s._httpd.shutdown()
            s._httpd.server_close()
            e.close()
    ref, got = (json.loads(open(t.flush()).read()) for t in tracers)
    keyed = {rid: {n for n in names if n not in ("flush", "device")}
             for rid, names in span_names_by_request(got).items()}
    assert keyed == span_names_by_request(ref)
    assert ({e["name"] for e in got["traceEvents"]}
            == {e["name"] for e in ref["traceEvents"]})
    six = {"admission", "queue", "flush", "device", "span_reduce", "respond"}
    by_rid = span_names_by_request(got)
    assert by_rid["r-0"] == by_rid["r-1"] == six  # cold
    assert by_rid["r-2"] == {"admission", "span_reduce", "respond"}  # hot


# -- measured flush ranking ---------------------------------------------------------


def _rank_case(module, grid_spec, pending, costs, starve):
    """A batcher of ``module`` with ``pending`` ({seq: [age seconds, ...]})
    queued and ``costs`` ({seq: cost or None}, or None for no hook); the
    oldest item pushed past the starvation bound when ``starve``. Returns
    the seq ``_rank_flush`` picks among every pending seq."""
    import time

    grid_cls = module.bucketing.BucketGrid
    hook = None if costs is None else (lambda seq, n: costs[seq])
    b = module.batcher.MicroBatcher(
        grid_cls.from_spec(grid_spec), lambda s, w: None,
        max_batch_delay_ms=0, queue_size=64, flush_cost_fn=hook)
    now = time.monotonic()
    for seq, ages in pending.items():
        b.submit_many([module.batcher.ChunkWork(seq=seq, payload=None)
                       for _ in ages])
        for w, age in zip(b._pending[seq], ages):
            w.enqueued_at = now - age
    if starve:
        oldest = min(pending, key=lambda s: -max(pending[s]))
        b._pending[oldest][0].enqueued_at = now - b._starve_after_s - 1.0
    with b._cv:
        return b._rank_flush(sorted(pending))


def test_rank_flush_picks_the_same_seq_as_jax():
    """Seeded random queues and costs through both batchers' ranking: the
    cheapest measured first, the unmeasured after them in ascending seq,
    oldest-first with no hook or no estimate at all, and the starvation
    guard."""
    import types

    from ml_recipe_tpu.serve import batcher as jbatcher
    from ml_recipe_tpu.serve import bucketing as jbucketing
    from ml_recipe_tpu_torch.serve import batcher as tbatcher
    from ml_recipe_tpu_torch.serve import bucketing as tbucketing

    jmod = types.SimpleNamespace(batcher=jbatcher, bucketing=jbucketing)
    tmod = types.SimpleNamespace(batcher=tbatcher, bucketing=tbucketing)
    rng = np.random.default_rng(7)
    spec = "2x64,4x64,2x128,8x128,2x256,4x384"
    seqs = [64, 128, 256, 384]
    picked = set()
    kinds = set()
    for _ in range(200):
        chosen = sorted(rng.choice(seqs, size=rng.integers(1, 5),
                                   replace=False).tolist())
        pending = {s: sorted(rng.uniform(0.0, 0.02, rng.integers(1, 4)),
                             reverse=True) for s in chosen}
        mode = rng.integers(0, 4)
        if mode == 0:
            costs = None                           # no hook
        elif mode == 1:
            costs = {s: None for s in seqs}        # nothing measured
        else:
            costs = {s: (None if rng.random() < 0.3
                         else float(rng.uniform(0.001, 0.01))) for s in seqs}
        starve = bool(rng.random() < 0.2)
        ref = _rank_case(jmod, spec, pending, costs, starve)
        got = _rank_case(tmod, spec, pending, costs, starve)
        assert got == ref, (pending, costs, starve)
        picked.add(got)
        kinds.add((int(mode), starve))
    assert picked == set(seqs) and len(kinds) == 8


def test_flush_order_of_take_matches_jax():
    """The JAX tests' three queues, drained by ``_take_locked`` in both
    packages: the cheapest measured program first, then oldest-first."""
    import time

    from ml_recipe_tpu.serve import batcher as jbatcher
    from ml_recipe_tpu.serve import bucketing as jbucketing
    from ml_recipe_tpu_torch.serve import batcher as tbatcher

    orders = []
    for batcher, grid_cls in ((jbatcher, jbucketing.BucketGrid),
                              (tbatcher, BucketGrid)):
        costs = {64: None, 128: 0.1, 256: None}
        b = batcher.MicroBatcher(grid_cls.from_spec("2x64,2x128,2x256"),
                                 lambda s, w: None, max_batch_delay_ms=0,
                                 queue_size=16,
                                 flush_cost_fn=lambda seq, n: costs[seq])
        for seq in (256, 64, 128):
            b.submit_many([batcher.ChunkWork(seq=seq, payload=None)])
            time.sleep(0.002)
        with b._cv:
            orders.append([b._take_locked()[0] for _ in range(3)])
    assert orders[0] == orders[1] == [128, 256, 64]


def test_program_signature_and_cost_key_equal_jax(engines):
    jeng, teng = engines.jax, engines.port
    saved = [(e.quantize, e._wire_ids_only) for e in (jeng, teng)]
    try:
        for quantize in ("off", "int8"):
            for ids_only in (True, False):
                for e in (jeng, teng):
                    e.quantize, e._wire_ids_only = quantize, ids_only
                assert teng._program_signature() == jeng._program_signature()
                for batch, seq in ((4, 64), (8, 64), (32, 384)):
                    assert teng._program_cost_key(batch, seq) == \
                        jeng._program_cost_key(batch, seq)
        assert teng._program_signature().startswith("h32l2n2v")
    finally:
        for e, (q, w) in zip((jeng, teng), saved):
            e.quantize, e._wire_ids_only = q, w


def test_eager_dispatch_on_the_card_keeps_a_cost_key_of_its_own(
        engines, monkeypatch):
    """With the store on, the card replays graphs and the key is the JAX
    string; with it off (``--aot_cache off``) the card launches eagerly and
    the cost is kept under a key of its own, so neither dispatch ranks
    flushes by the other's measurement. The CPU keeps the JAX string."""
    from ml_recipe_tpu_torch.ops import aot

    teng = engines.port
    want = engines.jax._program_cost_key(8, 64)
    for enabled in (True, False):
        monkeypatch.setattr(aot, "_instance", aot.ProgramCache(enabled=enabled))
        assert teng._program_cost_key(8, 64) == want
        monkeypatch.setattr(teng, "device", torch.device("cuda", 0))
        got = teng._program_cost_key(8, 64)
        assert got == (want if enabled else want + "-eager")
        monkeypatch.setattr(teng, "device", torch.device("cpu"))


def test_flush_hook_is_wired_only_with_autotune(engines, tmp_path):
    from ml_recipe_tpu.ops import autotune as jautotune
    from ml_recipe_tpu.serve.engine import QAEngine as JaxQAEngine
    from ml_recipe_tpu_torch.ops import autotune

    try:
        for enabled in (False, True):
            autotune.configure(enabled=enabled, cache_dir=tmp_path)
            jautotune.configure(enabled=enabled, cache_dir=tmp_path)
            engine = engines.make()
            jengine = JaxQAEngine(
                engines.jax.model, engines.jax.params, engines.jax.tokenizer,
                grid=JaxBucketGrid.from_spec("4x64,8x64"), mesh=build_mesh(),
                max_question_len=16, doc_stride=24)
            wired = engine.batcher._flush_cost_fn is not None
            assert wired == (jengine.batcher._flush_cost_fn is not None)
            assert wired == enabled
            engine.close()
            jengine.close()
    finally:
        autotune.reset()
        jautotune.reset()


def test_warmup_records_costs_and_a_warm_restart_measures_nothing(
        engines, tmp_path):
    """Warm-up measures each bucket's program once per tuning cache (eager
    forwards on the CPU) and persists it; a second engine on the same cache
    (a restarted process) measures nothing and ranks by the same costs."""
    from ml_recipe_tpu_torch.ops import autotune

    reports = []
    try:
        for _ in range(2):
            autotune.reset()
            autotune.configure(enabled=True, cache_dir=tmp_path)
            engine = engines.make()
            reports.append(engine.warmup())
            flush = {seq: engine._flush_cost(seq, 1) for seq in (64,)}
            engine.close()
    finally:
        autotune.reset()
    cold, warm = reports
    assert set(cold["program_costs"]) == {"4x64", "8x64"}
    assert all(isinstance(v, float) and v > 0
               for v in cold["program_costs"].values())
    assert cold["autotune"]["probes"] == 2 and cold["autotune"]["cache"] == "miss"
    assert warm["autotune"]["probes"] == 0 and warm["autotune"]["cache"] == "hit"
    assert warm["program_costs"] == cold["program_costs"]
    assert flush[64] == cold["program_costs"]["4x64"]
    # the cold warmup ran each bucket once and timed it COST_REPEATS + 1
    # times; the warm one ran each bucket once
    from ml_recipe_tpu_torch.serve.engine import COST_REPEATS

    assert cold["device_batches"] == 2 * (2 + COST_REPEATS)
    assert warm["device_batches"] == 2
    entry = json.loads(next(tmp_path.glob("*.torch.json")).read_text())
    key = f"serve-step-4x64-{engines.port._program_signature()}"
    assert entry["entries"][key]["cost_estimates"]["program"]["source"] == \
        "measured"
