"""The port's VAD (kaldi_aslp_tpu_torch/vad/, online/vad_pipeline.py,
online/vad_session.py, the VAD servers of cli/online_tools.py) and its
online MFCC on the CPU against the JAX package's: the VAD net's
components and its zip both ways, the FSM, the energy and NN detectors,
the energy-gated pipeline chunk by chunk, ``VadDecodeSession`` events,
the NN gate against JAX's composition of the same steps (its pipeline's
frames -> ``net.apply`` -> ``NnetVad``'s threshold -> ``Vad.smooth``;
the JAX pipeline itself never runs its VAD net), and both server
factories.  Inputs come from numpy seeds; features rtol=atol=1e-4 (the
fbank tests'), posteriors 1e-5."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.cli.online_tools import (
    ServerFlags as JaxServerFlags,
    _build_session_factory as jax_build_session_factory,
)
from kaldi_aslp_tpu.decoder import PackedGraph as JaxPackedGraph
from kaldi_aslp_tpu.decoder.online import (
    OnlineViterbiDecoder as JaxOnlineDecoder,
)
from kaldi_aslp_tpu.fst import Lang, Lexicon, make_unigram_grammar
from kaldi_aslp_tpu.fst.ctc_graph import ctc_lut, make_ctc_decode_graph
from kaldi_aslp_tpu.models import Nnet as JaxNnet
from kaldi_aslp_tpu.models.simple import (
    AffineTransform as JaxAffine,
    Sigmoid as JaxSigmoid,
    Softmax as JaxSoftmax,
)
from kaldi_aslp_tpu.online import (
    OnlineFeatureOptions as JaxFeatureOptions,
    OnlineFeaturePipeline as JaxFeaturePipeline,
    OnlineServerOptions as JaxServerOptions,
    OnlineTcpServer as JaxTcpServer,
)
from kaldi_aslp_tpu.online.vad_pipeline import (
    OnlineVadFeaturePipeline as JaxVadPipeline,
)
from kaldi_aslp_tpu.online.vad_session import (
    VadDecodeSession as JaxVadSession,
)
from kaldi_aslp_tpu.vad import (
    EnergyVad as JaxEnergyVad,
    NnetVad as JaxNnetVad,
    Vad as JaxVad,
    VadOptions as JaxVadOptions,
    ali_to_sil_targets as jax_ali_to_sil,
    select_frames as jax_select_frames,
)
from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv
from kaldi_aslp_tpu_torch.decoder.online import OnlineViterbiDecoder
from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph
from kaldi_aslp_tpu_torch.fst.fst import SymbolTable
from kaldi_aslp_tpu_torch.models import Nnet, Sigmoid, Softmax
from kaldi_aslp_tpu_torch.online import (
    OnlineFeatureOptions,
    OnlineFeaturePipeline,
    OnlineServerOptions,
    OnlineTcpServer,
    OnlineVadFeaturePipeline,
    VadDecodeSession,
)
from kaldi_aslp_tpu_torch.vad import (
    EnergyVad,
    NnetVad,
    Vad,
    VadOptions,
    ali_to_sil_targets,
    select_frames,
)

from test_torch_server import BINS, _stream, _write_files

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SR = 16000


def _two_bursts(seed=0, quiet_amp=2.0, tone_noise=20.0):
    """[silence, tone, silence, tone, silence] as float samples
    (tests/test_vad_session_convert.py:48-53).  Noise under the tone
    (``tone_noise``) keeps a frame's mel bins within float32 range of
    each other: a pure tone's far bins lie 1e11 below its peak, where two
    libraries' float32 FFTs part by 1e-2 in the log."""
    rs = np.random.RandomState(seed)
    t = np.arange(SR // 2) / SR
    tone = (5000 * np.sin(2 * np.pi * 300 * t)
            + tone_noise * rs.randn(len(t))).astype(np.float32)
    quiet = (quiet_amp * rs.randn(SR)).astype(np.float32)
    return np.concatenate([quiet, tone, quiet, tone, quiet])


def _chunks(audio, step=4000):
    return [audio[i:i + step] for i in range(0, len(audio), step)]


def _jax_vad_net(dim, seed=0):
    """The JAX recipe's VAD topology (recipes/vad.py:141-145) with weights
    set by hand so that it reads the mean log-mel value: speech where
    the CMN'd mean is high.  Output 0 is silence."""
    rs = np.random.RandomState(seed)
    net = JaxNnet()
    net.add(JaxAffine(dim, 32))
    net.add(JaxSigmoid(32, 32))
    net.add(JaxAffine(32, 2))
    net.add(JaxSoftmax(2, 2))
    params = net.init(jax.random.PRNGKey(0))
    params["0"] = {
        "w": (2.0 / dim + 0.01 * rs.randn(32, dim)).astype(np.float32),
        "b": (-1.0 + 0.01 * rs.randn(32)).astype(np.float32)}
    params["2"] = {
        "w": np.stack([-np.ones(32), np.ones(32)]).astype(np.float32) * 0.5,
        "b": np.array([8.0, -8.0], np.float32)}
    return net, params


def test_sigmoid_and_softmax_match_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(3, 5, 7).astype(np.float32) * 4
    for port_cls, jax_cls in ((Sigmoid, JaxSigmoid), (Softmax, JaxSoftmax)):
        got, _ = port_cls(7, 7)(torch.from_numpy(x))
        want, _ = jax_cls(7, 7).apply({}, jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_vad_net_zip_both_ways(tmp_path):
    net, params = _jax_vad_net(BINS)
    rs = np.random.RandomState(2)
    x = rs.randn(9, BINS).astype(np.float32)
    want = np.asarray(net.apply(params, jnp.asarray(x))[0])
    jax_zip, port_zip = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    net.save(jax_zip, params)
    port, _ = Nnet.load(jax_zip, "cpu")
    assert [type(c) for c in port.nodes][1::2] == [Sigmoid, Softmax]
    with torch.inference_mode():
        got, _ = port(torch.from_numpy(x)[None])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-6)
    port.save(port_zip)
    back, back_params, _ = JaxNnet.load(port_zip)
    np.testing.assert_allclose(
        np.asarray(back.apply(back_params, jnp.asarray(x))[0]), want,
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vad_smooth_matches_jax(seed):
    rs = np.random.RandomState(seed)
    raw = rs.rand(400) < rs.choice([0.2, 0.5, 0.8], 400)
    opts = dict(speech_trigger_ms=30, silence_trigger_ms=60, lookback_ms=40)
    np.testing.assert_array_equal(
        Vad(VadOptions(**opts)).smooth(raw),
        JaxVad(JaxVadOptions(**opts)).smooth(raw))
    np.testing.assert_array_equal(Vad().smooth(raw), JaxVad().smooth(raw))


def test_energy_vad_matches_jax():
    rs = np.random.RandomState(3)
    frames = rs.randn(120, 400).astype(np.float32) * np.repeat(
        rs.choice([0.01, 1.0, 30.0], 12), 10)[:, None]
    got, want = EnergyVad(device="cpu"), JaxEnergyVad()
    np.testing.assert_allclose(got.frame_scores(frames),
                               want.frame_scores(frames), rtol=1e-5)
    np.testing.assert_array_equal(got.detect(frames), want.detect(frames))
    np.testing.assert_array_equal(
        got.detect(torch.from_numpy(frames)), want.detect(frames))
    assert [got.is_speech_frame(f) for f in frames[::7]] == [
        want.is_speech_frame(f) for f in frames[::7]]
    np.testing.assert_array_equal(got.vad_all(frames), want.vad_all(frames))


def test_nnet_vad_and_helpers_match_jax():
    rs = np.random.RandomState(4)
    post = rs.dirichlet(np.ones(3), size=300).astype(np.float32)
    for ids, thr in (("0", 0.5), ("0:2", 0.6)):
        opts = dict(sil_pdf_ids=ids, sil_posterior_threshold=thr)
        np.testing.assert_array_equal(
            NnetVad(VadOptions(**opts)).detect_from_posteriors(post),
            JaxNnetVad(JaxVadOptions(**opts)).detect_from_posteriors(post))
    mask = rs.rand(300) < 0.5
    np.testing.assert_array_equal(select_frames(post, mask),
                                  jax_select_frames(post, mask))
    ali = rs.randint(0, 6, 50)
    np.testing.assert_array_equal(ali_to_sil_targets(ali, [0, 3]),
                                  jax_ali_to_sil(ali, [0, 3]))
    with pytest.raises(ValueError, match="no VAD net"):
        NnetVad().posteriors(np.zeros((2, 3), np.float32))


@pytest.mark.parametrize("apply_cmn", [False, True])
def test_energy_vad_pipeline_matches_jax_chunk_by_chunk(apply_cmn):
    opts = dict(feature_type="fbank", num_mel_bins=BINS, apply_cmn=apply_cmn)
    vad_opts = dict(speech_trigger_ms=30, silence_trigger_ms=60,
                    energy_threshold=8.0)
    got = OnlineVadFeaturePipeline(
        OnlineFeatureOptions(**opts), EnergyVad(VadOptions(**vad_opts),
                                                device="cpu"), device="cpu")
    want = JaxVadPipeline(JaxFeatureOptions(**opts),
                          JaxEnergyVad(JaxVadOptions(**vad_opts)))
    speech = boundaries = 0
    for chunk in _chunks(_two_bursts()):
        (f1, b1), (f2, b2) = (got.accept_waveform(chunk),
                              want.accept_waveform(chunk))
        assert b1 == b2
        np.testing.assert_allclose(f1, f2, **TOL)
        speech += len(f1)
        boundaries += b1
    assert speech > 0 and boundaries >= 1


def test_netless_nnet_vad_fails_the_pipeline():
    """An NnetVad without a net raises in the pipeline; it is never read
    as the energy gate."""
    gate = OnlineVadFeaturePipeline(
        OnlineFeatureOptions(num_mel_bins=BINS), NnetVad(VadOptions()),
        device="cpu")
    with pytest.raises(ValueError, match="no VAD net"):
        for chunk in _chunks(_two_bursts()):
            gate.accept_waveform(chunk)


def _jax_nn_gate(net, params, vad_opts, feat_opts, chunks):
    """JAX's steps for an NN gate, composed by hand: the JAX pipeline's
    frames, ``net.apply``, ``NnetVad``'s threshold, ``Vad.smooth`` per
    call, the pipeline's boundary rule."""
    feats = JaxFeaturePipeline(feat_opts)
    vad = JaxNnetVad(vad_opts)
    in_speech = False
    out = []
    for chunk in chunks:
        frames = feats.accept_waveform(chunk)
        if len(frames) == 0:
            out.append((np.zeros((0, feats.dim), np.float32), False, None))
            continue
        post = np.asarray(net.apply(params, jnp.asarray(frames))[0])
        sil = post[:, vad.sil_ids].sum(axis=1)
        smoothed = vad.smooth(sil < vad.opts.sil_posterior_threshold)
        boundary = False
        if in_speech and not smoothed.any():
            boundary, in_speech = True, False
        elif smoothed.any():
            in_speech = True
        out.append((frames[smoothed], boundary, post))
    return out


def test_nnet_vad_pipeline_matches_jax_composition(tmp_path):
    net, params = _jax_vad_net(BINS)
    path = str(tmp_path / "vad.zip")
    net.save(path, params)
    vad_net, _ = Nnet.load(path, "cpu")
    feat_opts = dict(num_mel_bins=BINS)
    vad_opts = dict(sil_posterior_threshold=0.4)
    nvad = NnetVad(VadOptions(**vad_opts), net=vad_net)
    got = OnlineVadFeaturePipeline(OnlineFeatureOptions(**feat_opts), nvad,
                                   device="cpu")
    chunks = _chunks(_two_bursts())
    want = _jax_nn_gate(net, params, JaxVadOptions(**vad_opts),
                        JaxFeatureOptions(**feat_opts), chunks)
    calls = speech = boundaries = 0
    for chunk, (wf, wb, post) in zip(chunks, want):
        f, b = got.accept_waveform(chunk)
        assert b == wb
        np.testing.assert_allclose(f, wf, **TOL)
        calls += post is not None
        speech += len(f)
        boundaries += b
    # one VAD-net forward a call that had frames, and the gate gated
    assert nvad.num_forwards == calls > 0
    assert 0 < speech < sum(len(w[0]) for w in want) + 1
    assert boundaries >= 1
    # the net's posteriors against JAX's on the same frames
    frames = np.random.RandomState(5).randn(40, BINS).astype(np.float32)
    np.testing.assert_allclose(
        nvad.posteriors(frames),
        np.asarray(net.apply(params, jnp.asarray(frames))[0]),
        rtol=0, atol=1e-5)


def test_online_mfcc_matches_jax_chunk_by_chunk():
    opts = dict(feature_type="mfcc", num_ceps=13)
    got = OnlineFeaturePipeline(OnlineFeatureOptions(**opts), device="cpu")
    want = JaxFeaturePipeline(JaxFeatureOptions(**opts))
    assert got.dim == want.dim == 13
    n = 0
    for chunk in _chunks(_two_bursts(1), 3000):
        f1, f2 = got.accept_waveform(chunk), want.accept_waveform(chunk)
        np.testing.assert_allclose(f1, f2, **TOL)
        n += len(f1)
    assert n > 300


def _yes_setup():
    lang = Lang.build(Lexicon.from_text("YES Y\nNO N\n<SIL> SIL\n"))
    tlg = make_ctc_decode_graph(
        lang, make_unigram_grammar({"YES": 0.5, "NO": 0.5}, lang.words))
    return lang, tlg, ctc_lut(len(lang.phones))


def test_vad_session_events_match_jax():
    """tests/test_vad_session_convert.py's session on both packages: the
    same acoustic_fn (every speech frame a confident Y)."""
    lang, tlg, lut = _yes_setup()
    V, yid = len(lang.phones), lang.phones.id("Y")

    def acoustic_fn(frames):
        ll = np.full((len(frames), V), np.log(0.05), np.float32)
        ll[:, yid] = np.log(0.8)
        return ll

    feat = dict(feature_type="fbank", num_mel_bins=23, apply_cmn=False)
    vad = dict(speech_trigger_ms=30, silence_trigger_ms=60,
               energy_threshold=8.0)
    words = SymbolTable.from_text(lang.words.to_text())
    got = VadDecodeSession(
        OnlineVadFeaturePipeline(
            OnlineFeatureOptions(**feat),
            EnergyVad(VadOptions(**vad), device="cpu"), device="cpu"),
        OnlineViterbiDecoder(PackedGraph.from_fst(tlg), lut, 1.0,
                             device="cpu"),
        acoustic_fn, words, chunk_frames=8)
    want = JaxVadSession(
        JaxVadPipeline(JaxFeatureOptions(**feat),
                       JaxEnergyVad(JaxVadOptions(**vad))),
        JaxOnlineDecoder(JaxPackedGraph.from_fst(tlg), lut, 1.0,
                         chunk_bucket=8),
        acoustic_fn, lang.words, chunk_frames=8)
    events = {id(s): [] for s in (got, want)}
    for chunk in _chunks(_two_bursts(tone_noise=0.0)):
        for s in (got, want):
            events[id(s)].extend(s.accept_samples(chunk))
    for s in (got, want):
        events[id(s)].append(s.finalize())
    assert events[id(got)] == events[id(want)]
    finals = [e for e in events[id(got)] if e["type"] == "final"
              and e["text"]]
    assert len(finals) >= 2 and all("YES" in f["text"] for f in finals)
    assert got.finals == want.finals


def _pcm16(audio):
    return np.clip(audio, -32768, 32767).astype("<i2").tobytes()


def test_energy_vad_server_matches_jax(tmp_path):
    paths = _write_files(tmp_path)
    pcm = _pcm16(_two_bursts(2, quiet_amp=20.0))
    want = asyncio.run(_stream(JaxTcpServer(
        jax_build_session_factory(
            JaxServerFlags(num_mel_bins=BINS, energy_threshold=9.0), paths,
            use_energy_vad=True), JaxServerOptions(port=0)), pcm))
    factory = session_factory_from_argv(
        ["--device=cpu", f"--num-mel-bins={BINS}", "--energy-threshold=9.0",
         *paths], use_energy_vad=True)
    sessions = []

    def make():
        sessions.append(factory())
        return sessions[-1]

    got = asyncio.run(_stream(
        OnlineTcpServer(make, OnlineServerOptions(port=0)), pcm))
    assert isinstance(sessions[0], VadDecodeSession)
    assert isinstance(sessions[0].vad.vad, EnergyVad)
    assert sessions[0].vad.vad.opts.energy_threshold == 9.0
    assert got == want
    assert [e["type"] for e in got].count("final") >= 2


def test_energy_vad_server_refuses_a_vad_net(tmp_path):
    paths = _write_files(tmp_path)
    with pytest.raises(ValueError, match="vad-nnet"):
        session_factory_from_argv(
            ["--device=cpu", "--vad-nnet=vad.zip", *paths],
            use_energy_vad=True)


def test_nnet_vad_server_gates_by_its_net(tmp_path):
    """--vad-nnet: the session's gate is the net's posteriors (at
    --sil-threshold), equal call by call to JAX's composition."""
    paths = _write_files(tmp_path)
    net, params = _jax_vad_net(BINS)
    vad_zip = str(tmp_path / "vad.zip")
    net.save(vad_zip, params)
    factory = session_factory_from_argv(
        ["--device=cpu", f"--num-mel-bins={BINS}", f"--vad-nnet={vad_zip}",
         "--sil-threshold=0.4", *paths])
    session = factory()
    assert isinstance(session, VadDecodeSession)
    nvad = session.vad.vad
    assert isinstance(nvad, NnetVad) and nvad.net is factory.vad_net
    assert nvad.opts.sil_posterior_threshold == 0.4
    chunks = _chunks(_two_bursts())
    want = _jax_nn_gate(net, params, JaxVadOptions(
        sil_posterior_threshold=0.4), JaxFeatureOptions(num_mel_bins=BINS),
        chunks)
    gated = []
    inner = session.vad.accept_waveform

    def spy(samples):
        out = inner(samples)
        gated.append(out)
        return out
    session.vad.accept_waveform = spy
    for chunk in chunks:
        session.accept_samples(chunk)
    session.finalize()
    assert nvad.num_forwards == sum(w[2] is not None for w in want) > 0
    for (f, b), (wf, wb, _) in zip(gated, want):
        assert b == wb
        np.testing.assert_allclose(f, wf, **TOL)
