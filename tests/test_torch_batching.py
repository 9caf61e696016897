"""The port's cross-session acoustic batching
(kaldi_aslp_tpu_torch/online/batching.py) on the CPU: the JAX test's toy
forward and assertions (tests/test_cross_session_batching.py), a small
two-layer BLSTMP net carried across from JAX whose batched scores must
equal each session's own S = 1 scores (1e-5), and B clients through
``OnlineTcpServer`` + ``BatchedDecodeSession`` against JAX's batched
sessions on the same audio and weights (the same finals)."""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.decoder import PackedGraph as JaxPackedGraph
from kaldi_aslp_tpu.decoder.online import (
    OnlineViterbiDecoder as JaxOnlineDecoder,
)
from kaldi_aslp_tpu.fst.fst import (
    Fst as JaxFst,
    SymbolTable as JaxSymbolTable,
)
from kaldi_aslp_tpu.models import Nnet as JaxNnet
from kaldi_aslp_tpu.online import (
    AcousticBatcher as JaxBatcher,
    BatchedDecodeSession as JaxBatchedSession,
    OnlineFeatureOptions as JaxFeatureOptions,
    OnlineFeaturePipeline as JaxFeaturePipeline,
    OnlineServerOptions as JaxServerOptions,
    OnlineTcpServer as JaxTcpServer,
)
from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv
from kaldi_aslp_tpu_torch.online import (
    AcousticBatcher,
    BatchedDecodeSession,
    OnlineServerOptions,
    OnlineTcpServer,
)

from test_torch_server import BINS, _pcm, _write_files

torch.set_num_threads(1)


def _forward(calls):
    def fn(x, mask):
        calls.append(x.shape)
        # toy "acoustic model": per-frame scores = cumulative sums so
        # results depend on the session's own features only
        return x.cumsum(axis=1)[:, :, :4]
    return fn


def test_batcher_coalesces_concurrent_requests():
    calls = []
    batcher = AcousticBatcher(_forward(calls), max_batch=8,
                              max_wait_ms=10.0, t_bucket=8)

    async def session(i, T):
        feats = np.full((T, 6), float(i), np.float32)
        out = await batcher.compute(feats)
        assert out.shape == (T, 4)
        np.testing.assert_allclose(out[:, 0],
                                   (np.arange(T) + 1) * float(i))
        return i

    async def main():
        return await asyncio.gather(*[
            session(i + 1, T) for i, T in enumerate([5, 9, 3, 8])])

    assert asyncio.run(main()) == [1, 2, 3, 4]
    # all four requests shared ONE padded forward
    assert batcher.num_batches == 1 and batcher.num_requests == 4
    assert calls[0] == (4, 16, 6)  # padded to t_bucket multiple


def test_batcher_defaults_are_jax_s():
    fn = _forward([])
    got, want = AcousticBatcher(fn), JaxBatcher(fn)
    assert (got.max_batch, got.max_wait_s, got.t_bucket) == (
        want.max_batch, want.max_wait_s, want.t_bucket) == (16, 0.005, 32)


def test_batcher_respects_max_batch():
    calls = []
    batcher = AcousticBatcher(_forward(calls), max_batch=2,
                              max_wait_ms=50.0, t_bucket=4)

    async def main():
        return await asyncio.gather(*[
            batcher.compute(np.ones((4, 6), np.float32))
            for _ in range(5)])

    assert len(asyncio.run(main())) == 5
    assert batcher.num_batches >= 3  # 2 + 2 + 1
    assert all(shape[0] <= 2 for shape in calls)


def test_batcher_error_reaches_every_waiter():
    def bad(x, mask):
        raise ValueError("boom")

    batcher = AcousticBatcher(bad, max_batch=3, max_wait_ms=1.0)

    async def main():
        return await asyncio.gather(*[
            batcher.compute(np.ones((4, 6), np.float32)) for _ in range(3)],
            return_exceptions=True)

    outs = asyncio.run(main())
    assert len(outs) == 3 and all(isinstance(o, ValueError) for o in outs)
    assert batcher.num_batches == 0


def test_batched_scores_equal_each_sessions_own(tmp_path):
    """A padded [B, T_p] forward of the two-layer BLSTMP net (written by
    JAX) gives each row the scores of that row's frames alone at S = 1,
    and JAX's scores for them."""
    paths = _write_files(tmp_path)
    factory = session_factory_from_argv(
        ["--device=cpu", f"--num-mel-bins={BINS}", *paths])
    rs = np.random.RandomState(3)
    chunks = [rs.randn(T, BINS).astype(np.float32) for T in (16, 16, 9, 3)]
    batcher = AcousticBatcher(factory.batched_acoustic_fn)

    async def main():
        return await asyncio.gather(*[batcher.compute(c) for c in chunks])

    got = asyncio.run(main())
    assert batcher.num_batches == 1
    net, params, _ = JaxNnet.load(paths[0])
    for c, g in zip(chunks, got):
        np.testing.assert_allclose(g, factory.acoustic_fn(c), rtol=0,
                                   atol=1e-5)
        y, _ = net.apply(params, jnp.asarray(c)[None])
        want = np.asarray(jax.nn.log_softmax(y[0], axis=-1))
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-5)


async def _serve_clients(server, pcms, chunk_bytes=4000):
    """Every client streams at once; returns each one's events."""
    port = await server.start()

    async def client(pcm):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        for i in range(0, len(pcm), chunk_bytes):
            writer.write(pcm[i:i + chunk_bytes])
            await writer.drain()
        writer.write_eof()
        events = [json.loads(line) async for line in reader]
        writer.close()
        return events

    try:
        return await asyncio.gather(*[client(p) for p in pcms])
    finally:
        await server.stop()


def _jax_batched_factory(paths):
    net, params, _ = JaxNnet.load(paths[0])
    lut = np.loadtxt(paths[1], dtype=np.int64).reshape(-1)
    with open(paths[2]) as f:
        packed = JaxPackedGraph.from_fst(JaxFst.from_text(f.read()))
    with open(paths[3]) as f:
        words = JaxSymbolTable.from_text(f.read())

    def forward(x, mask):
        y, _ = net.apply(params, jnp.asarray(x), mask=jnp.asarray(mask))
        return np.asarray(jax.nn.log_softmax(y, axis=-1))

    batcher = JaxBatcher(forward)

    def make():
        return JaxBatchedSession(
            JaxFeaturePipeline(JaxFeatureOptions(num_mel_bins=BINS)),
            JaxOnlineDecoder(packed, lut, 1.0), batcher.compute, words,
            chunk_frames=16)
    return make, batcher


def test_batched_server_matches_jax_batched_server(tmp_path):
    paths = _write_files(tmp_path)
    pcms = [_pcm(seed) for seed in range(3)]
    jax_make, jax_batcher = _jax_batched_factory(paths)
    want = asyncio.run(_serve_clients(
        JaxTcpServer(jax_make, JaxServerOptions(port=0)), pcms))
    factory = session_factory_from_argv(
        ["--device=cpu", f"--num-mel-bins={BINS}", *paths])
    batcher = AcousticBatcher(factory.batched_acoustic_fn)
    sessions = []

    def make():
        sessions.append(factory.batched_session(batcher))
        return sessions[-1]

    got = asyncio.run(_serve_clients(
        OnlineTcpServer(make, OnlineServerOptions(port=0)), pcms))
    assert all(isinstance(s, BatchedDecodeSession) for s in sessions)
    finals = [[e["text"] for e in ev if e["type"] == "final"] for ev in got]
    assert finals == [[e["text"] for e in ev if e["type"] == "final"]
                      for ev in want]
    assert all(ev[-1]["type"] == "final" for ev in got)
    assert sorted(s.finals for s in sessions) == sorted(finals)
    # the sessions shared calls, as JAX's did
    assert batcher.num_batches < batcher.num_requests
    assert batcher.num_requests == jax_batcher.num_requests


def test_batched_session_refuses_the_sync_calls(tmp_path):
    paths = _write_files(tmp_path)
    factory = session_factory_from_argv(
        ["--device=cpu", f"--num-mel-bins={BINS}", *paths])
    session = factory.batched_session(AcousticBatcher(_forward([])))
    with pytest.raises(RuntimeError, match="async"):
        session.accept_samples(np.zeros(160, np.float32))
    with pytest.raises(RuntimeError, match="async"):
        session.finalize()
