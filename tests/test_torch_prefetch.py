"""The port's batch prefetch against the JAX package's: the same batch
stream and resume states from the same seeds, whatever the producers'
timing, and a producer's failure raised to the consumer."""
import sys

import numpy as np
import pytest
import torch

from relationprediction_tpu.training.engine import (
    BatchPipeline as JaxBatchPipeline)
from relationprediction_tpu.training.engine import (
    _Prefetcher as JaxPrefetcher)
from relationprediction_torch.observability import collect
from relationprediction_torch.training.engine import (BatchPipeline,
                                                      _Prefetcher)

from test_torch_train_step import case

CPU = torch.device("cpu")
SEED = 4


def pipeline_pairs(threads, graph_batch_size=600):
    """(JAX pipelines, port pipelines), seeded as the TrainLoops seed
    their producers: ``SEED``, then ``SEED + 1000 + w``."""
    ds, (jcfg, jmodel, _), (tcfg, model) = case("synthetic",
                                                graph_batch_size)
    seeds = [SEED] + [SEED + 1000 + w for w in range(threads - 1)]
    return ([JaxBatchPipeline(jmodel, jcfg, ds, np.random.default_rng(s),
                              device_negatives=True) for s in seeds],
            [BatchPipeline(model, tcfg, ds, np.random.default_rng(s))
             for s in seeds])


def graph_edges(batch, train):
    """The message graph's (s, r, o) rows from the port's CSR by receiver,
    sorted, after checking they are the train rows of ``edge_ids``."""
    fwd = batch.graph.fwd
    tgt = np.repeat(np.arange(fwd.n_rows), np.diff(fwd.row_ptr.numpy()))
    got = np.stack([fwd.src.numpy(), fwd.rel.numpy(), tgt], axis=1)
    got = got[np.lexsort(got.T[::-1])]
    want = train[batch.edge_ids]
    np.testing.assert_array_equal(got, want[np.lexsort(want.T[::-1])])
    return got


def jax_graph_edges(batch):
    g = batch.graph
    real = np.asarray(g.mask) > 0
    rows = np.stack([np.asarray(g.senders)[real],
                     np.asarray(g.relations)[real],
                     np.asarray(g.receivers)[real]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("start_offset", [0, 1])
@pytest.mark.parametrize("threads", [1, 2])
def test_prefetched_stream_equals_jax(threads, start_offset):
    jpipes, tpipes = pipeline_pairs(threads)
    jpf = JaxPrefetcher(jpipes, start_offset=start_offset)
    tpf = _Prefetcher(tpipes, CPU, start_offset=start_offset)
    try:
        for _ in range(6):
            jb = jpf.next()
            with collect() as sink:
                tb, built = tpf.next()
            assert built["batch.build"][0] > 0
            assert sink["fit.batch_wait"][0] >= 0
            np.testing.assert_array_equal(tb.triples.numpy(), jb.triples)
            np.testing.assert_array_equal(tb.mask.numpy(), jb.mask)
            np.testing.assert_array_equal(
                graph_edges(tb, tpipes[0].train), jax_graph_edges(jb))
            assert tpf.states() == jpf.states()
    finally:
        jpf.close()
        tpf.close()
    # closing puts each pipeline back at its consumption point
    assert [p.state() for p in tpipes] == tpf.states()[0]


def test_one_producer_gives_the_serial_stream():
    _, (serial,) = pipeline_pairs(1)
    _, tpipes = pipeline_pairs(1)
    tpf = _Prefetcher(tpipes, CPU)
    try:
        for _ in range(4):
            want, (got, _) = serial.next(), tpf.next()
            np.testing.assert_array_equal(got.triples.numpy(),
                                          want.triples.numpy())
            np.testing.assert_array_equal(got.edge_ids, want.edge_ids)
    finally:
        tpf.close()


def test_producer_exception_is_raised_on_next():
    _, tpipes = pipeline_pairs(2)
    made = []

    def failing_next(original=tpipes[1].next):
        if len(made) == 2:
            raise RuntimeError("sampler failed")
        made.append(1)
        return original()
    tpipes[1].next = failing_next
    tpf = _Prefetcher(tpipes, CPU)
    try:
        with pytest.raises(RuntimeError, match="sampler failed"):
            for _ in range(20):
                tpf.next()
    finally:
        tpf.close(timeout=10)
    assert not any(t.is_alive() for t in tpf.threads)


def test_many_producers_under_fast_thread_switching():
    """8 producers, more than this machine may have cores, switching
    threads every microsecond: the consumed stream is still the round
    robin of each pipeline's own stream."""
    _, tpipes = pipeline_pairs(8, graph_batch_size=100)
    _, serial = pipeline_pairs(8, graph_batch_size=100)
    want = [[p.next().edge_ids for _ in range(3)] for p in serial]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tpf = _Prefetcher(tpipes, CPU, depth=16)
    try:
        got = [tpf.next()[0].edge_ids for _ in range(24)]
    finally:
        tpf.close(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in tpf.threads)
    for k, ids in enumerate(got):
        np.testing.assert_array_equal(ids, want[k % 8][k // 8])
