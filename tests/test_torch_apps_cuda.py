"""The application layer on the card against the CPU: a frame-training
step of the KWS recipe's phone DNN (loss and parameters within 1e-5 of
each tensor's largest magnitude, TF32 off), both recipes at small sizes
(results within 1e-4, their files byte for byte, the GMM VAD's masks
equal: its statistics are float64), and the tensor tools of the VAD CLI
with ``--device=cuda`` against ``--device=cpu`` (stdout and tables
equal, the GMM files within 1e-5).

These tests skip where there is no CUDA card.  This file imports no
JAX; run it on the card with ``python -m pytest --noconftest
tests/test_torch_apps_cuda.py -q``."""

import contextlib
import io

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.cli.__main__ import main
from kaldi_aslp_tpu_torch.io import (
    WaveData,
    int_vector_writer,
    matrix_writer,
    sequential_int_vector_reader,
    write_wave,
)
from kaldi_aslp_tpu_torch.recipes import kws, vad
from kaldi_aslp_tpu_torch.train import (
    FrameTrainer,
    NnetTrainOptions,
    init_velocity,
)
from kaldi_aslp_tpu_torch.vad import train_gmm_vad

STEP_TOL, RESULT_TOL, GMM_TOL = 1e-5, 1e-4, 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = (torch.as_tensor(x).detach().double().cpu()
                 for x in (got, want))
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-6))


def numpy_init(net, seed=0):
    """A state dict drawn from a numpy seed (the card and the CPU start
    from the same weights)."""
    rs = np.random.RandomState(seed)
    return {k: torch.from_numpy((0.1 * rs.randn(*v.shape)).astype(
        np.float32)) for k, v in net.state_dict().items()}


@pytest.mark.cuda
def test_kws_frame_step_card_matches_cpu():
    dev = _card()
    rs = np.random.RandomState(1)
    x = rs.randn(256, 23).astype(np.float32)
    y = rs.randint(0, len(kws.PHONES), 256).astype(np.int32)
    out = {}
    for d in ("cpu", dev):
        net = kws.build_net(23)
        net.load_state_dict(numpy_init(net))
        net.to(d)
        trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.9))
        velocity = init_velocity(net)
        losses = []
        for _ in range(3):
            batch = trainer._upload((x, y), torch.device(d))
            loss, _ = trainer.step(velocity, batch, 0.1)
            losses.append(float(loss))
        out[str(d)] = (losses, {k: v.cpu() for k, v in
                                net.state_dict().items()})
    (cl, cp), (gl, gp) = out["cpu"], out["cuda"]
    assert max(abs(a - b) / abs(b) for a, b in zip(gl, cl)) <= STEP_TOL
    for k in cp:
        assert _rel(gp[k], cp[k]) <= STEP_TOL, k


@pytest.mark.cuda
def test_gmm_vad_card_matches_cpu():
    dev = _card()
    waves, labels = vad.synthesize(4, seed=9)
    from kaldi_aslp_tpu_torch.feats.fbank import Fbank
    from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
    fb = Fbank(FrameExtractionOptions(samp_freq=8000.0, dither=0.0),
               device="cpu")
    feats, labs = vad.featurize(fb, waves, labels)
    x, y = np.concatenate(feats), np.concatenate(labs)
    got = train_gmm_vad(x, y, num_gauss=8, num_iters=6, device=dev)
    want = train_gmm_vad(x, y, num_gauss=8, num_iters=6, device="cpu")
    for g, w in ((got.sil_gmm, want.sil_gmm),
                 (got.speech_gmm, want.speech_gmm)):
        for k in ("weights", "means", "vars"):
            assert _rel(getattr(g, k), getattr(w, k)) <= GMM_TOL, k
    for f in feats:
        np.testing.assert_array_equal(got.detect(f), want.detect(f))


@pytest.mark.cuda
def test_recipes_card_match_cpu(tmp_path):
    dev = _card()
    for mod, sizes, files in (
            (kws, dict(num_train=8, num_test=6),
             ("keyword.fst.txt", "roc.txt")),
            (vad, dict(num_train=6, num_test=3),
             ("segment.info", "u0.TextGrid"))):
        net = mod.build_net(23)
        init = numpy_init(net)
        got = mod.run(str(tmp_path / "card"), init_params=init, device=dev,
                      **sizes)
        want = mod.run(str(tmp_path / "cpu"), init_params=init,
                       device="cpu", **sizes)
        for k in want:
            assert abs(got[k] - want[k]) <= RESULT_TOL, (k, got, want)
        for name in files:
            assert (tmp_path / "card" / name).read_bytes() == \
                (tmp_path / "cpu" / name).read_bytes(), name


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _ints(path):
    return {k: v.tolist() for k, v in
            sequential_int_vector_reader(f"ark:{path}")}


@pytest.mark.cuda
def test_vad_tensor_tools_card_match_cpu(tmp_path):
    _card()
    waves, labels = vad.synthesize(3, seed=11)
    from kaldi_aslp_tpu_torch.feats.fbank import Fbank
    from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
    fb = Fbank(FrameExtractionOptions(samp_freq=8000.0, dither=0.0),
               device="cpu")
    feats, labs = vad.featurize(fb, waves, labels)
    lines = []
    with matrix_writer(f"ark:{tmp_path / 'f.ark'}") as fw, \
            int_vector_writer(f"ark:{tmp_path / 'ref.ark'}") as lw, \
            int_vector_writer(f"ark:{tmp_path / 'inv.ark'}") as iw:
        for i, (w, f, lab) in enumerate(zip(waves, feats, labs)):
            write_wave(str(tmp_path / f"u{i}.wav"), WaveData(8000.0, w[None]))
            lines.append(f"u{i} {tmp_path / f'u{i}.wav'}")
            fw[f"u{i}"], lw[f"u{i}"], iw[f"u{i}"] = f, lab, 1 - lab
    (tmp_path / "wav.scp").write_text("\n".join(lines) + "\n")
    F, R = f"ark:{tmp_path / 'f.ark'}", f"ark:{tmp_path / 'ref.ark'}"
    for cls, mask in (("sil", "inv.ark"), ("speech", "ref.ark")):
        _cli(["aslp-select-frames", F, f"ark:{tmp_path / mask}",
              f"ark:{tmp_path / cls}.ark"])
    res = {}
    for d in ("cpu", "cuda"):
        flag = f"--device={d}"
        _cli(["aslp-apply-energy-vad", flag, "--energy-threshold=14",
              f"scp:{tmp_path / 'wav.scp'}", f"ark:{tmp_path / d}_e.ark"])
        for cls in ("sil", "speech"):
            _cli(["gmm-global-init-from-feats", flag, "--num-gauss=4",
                  "--num-iters=4", f"ark:{tmp_path / cls}.ark",
                  str(tmp_path / f"{d}_{cls}.npz")])
        models = [str(tmp_path / f"{d}_{c}.npz") for c in ("sil", "speech")]
        _cli(["aslp-apply-gmm-vad", flag] + models +
             [F, f"ark:{tmp_path / d}_g.ark"])
        res[d] = _cli(["aslp-eval-gmm-vad", flag] + models + [F, R])
    assert res["cuda"] == res["cpu"] and "AUC" in res["cpu"]
    for name in ("e", "g"):
        assert _ints(tmp_path / f"cuda_{name}.ark") == \
            _ints(tmp_path / f"cpu_{name}.ark")
    for cls in ("sil", "speech"):
        got, want = (np.load(tmp_path / f"{d}_{cls}.npz")
                     for d in ("cuda", "cpu"))
        for k in want.files:
            assert _rel(got[k], want[k]) <= GMM_TOL, (cls, k)
