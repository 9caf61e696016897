"""VAD recipe: synthesize audio, train and score the three detector
families end to end, segment and write a TextGrid.

Port of kaldi_aslp_tpu/recipes/vad.py (reference: the aslp_scripts/vad
pipeline: run_energy_vad.sh, run_gmm_vad.sh (train_diag_gmm.sh per
class), run_dnn_vad.sh (DNN sil/speech posteriors), calc_auc.sh /
calc_eer.sh scoring, and do_vad_segment.sh +
gen_textgrid_according_vad_interval.py for segment inspection).

The waveforms are the JAX recipe's, bit for bit (the same
``np.random.RandomState`` draws in the same order: seeds 777 and 778,
the batch order's 0).  On ``device`` (the card unless the caller asks
for the CPU): fbank, the energy VAD's frame scores, the GMM VAD's
statistics (float64), the DNN's ``FrameTrainer`` steps and its
posteriors.  Host numpy: the FSM, AUC / EER, the segments and the
TextGrid.

The initial DNN parameters are ``init_params`` (a state dict in the
port's format; a test carries JAX's ``PRNGKey(0)`` draws across through
models/interop.py) or, without it, draws from a ``torch.Generator``
seeded 0 (not JAX's numbers: the two generators differ).  What the run
made stays in ``run.artifacts``.

Run: python -m kaldi_aslp_tpu_torch.recipes.vad [workdir] [--device=cpu]
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.fbank import Fbank
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.models.nnet import Nnet
from kaldi_aslp_tpu_torch.models.simple import (
    AffineTransform,
    Sigmoid,
    Softmax,
)
from kaldi_aslp_tpu_torch.train import (
    FrameTrainer,
    NnetTrainOptions,
    init_velocity,
)
from kaldi_aslp_tpu_torch.utils.device import resolve_device
from kaldi_aslp_tpu_torch.utils.log import get_logger
from kaldi_aslp_tpu_torch.vad import (
    EnergyVad,
    NnetVad,
    VadOptions,
    auc,
    eer,
    intervals_to_textgrid,
    train_gmm_vad,
)

logger = get_logger("vad_recipe")

SAMP_FREQ = 8000.0
HIDDEN = 32
BATCH = 256


def synthesize(num_utts: int, seed: int = 777):
    """Utterances of alternating noise-floor silence and band-limited
    speech-like bursts; returns (waveforms, frame_labels)."""
    rng = np.random.RandomState(seed)
    wavs: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    shift = int(SAMP_FREQ * 0.01)
    for _ in range(num_utts):
        chunks, lab = [], []
        for seg in range(rng.randint(4, 8)):
            dur = 0.2 + 0.4 * rng.rand()
            n = int(dur * SAMP_FREQ)
            t = np.arange(n) / SAMP_FREQ
            if seg % 2 == 1:
                f0 = 120 + 180 * rng.rand()
                sig = np.hanning(n) * sum(
                    (2500 / (k + 1)) * np.sin(
                        2 * np.pi * f0 * (k + 1) * t + rng.rand())
                    for k in range(4))
                is_speech = 1
            else:
                sig = np.zeros(n)
                is_speech = 0
            chunks.append(sig)
            lab.append(np.full(n, is_speech, np.int32))
        wave = np.concatenate(chunks)
        wave = wave + 40 * rng.randn(len(wave))
        frame_lab = np.concatenate(lab)
        # per-frame label: majority over the 25ms window start grid
        n_frames = max(0, (len(wave) - int(SAMP_FREQ * 0.025)) // shift + 1)
        fl = np.array([
            frame_lab[i * shift: i * shift + int(SAMP_FREQ * 0.025)].mean()
            > 0.5
            for i in range(n_frames)
        ], np.int32)
        wavs.append(wave.astype(np.float32))
        labels.append(fl)
    return wavs, labels


def mask_to_intervals(mask: np.ndarray) -> List[Tuple[int, int]]:
    """Speech mask -> [(start_frame, end_frame)] (do_vad_segment.sh
    role, the aslp-apply-nn-vad-segment output format)."""
    mask = np.asarray(mask, bool)
    edges = np.flatnonzero(np.diff(np.concatenate(
        [[0], mask.view(np.int8), [0]])))
    return [(int(edges[i]), int(edges[i + 1]))
            for i in range(0, len(edges), 2)]


def build_net(dim: int) -> Nnet:
    """The DNN VAD: Affine to 32, Sigmoid, Affine to 2, Softmax
    (run_dnn_vad.sh's sil/speech net)."""
    net = Nnet()
    net.add(AffineTransform(dim, HIDDEN))
    net.add(Sigmoid(HIDDEN, HIDDEN))
    net.add(AffineTransform(HIDDEN, 2))
    net.add(Softmax(2, 2))
    return net


def init_net(net: Nnet, init_params: Optional[Mapping[str, torch.Tensor]],
             seed: int = 0) -> None:
    """``init_params`` (a state dict) into ``net``, or draws from a
    ``torch.Generator`` seeded ``seed`` without it."""
    if init_params is not None:
        net.load_state_dict({k: torch.as_tensor(v)
                             for k, v in init_params.items()})
    else:
        net.reset_parameters(torch.Generator().manual_seed(seed))


@torch.no_grad()
def posteriors(net: Nnet, feats: np.ndarray, device: torch.device
               ) -> np.ndarray:
    """[T, D] -> [T, P] softmax outputs, one eval forward on ``device``."""
    net.eval()
    y, _ = net(torch.from_numpy(np.ascontiguousarray(feats, np.float32)
                                ).to(device))
    return y.cpu().numpy()


def featurize(fbank: Fbank, waves, labels):
    """Each wave's fbank (cut to its label count) and labels."""
    fs, ls = [], []
    for w, l in zip(waves, labels):
        f = fbank(w).cpu().numpy()
        n = min(len(f), len(l))
        fs.append(f[:n])
        ls.append(l[:n])
    return fs, ls


def frame_batches(xs: np.ndarray, ys: np.ndarray, bs: int = BATCH):
    """The epoch's full minibatches in order (the tail is dropped, as
    JAX's recipe does)."""
    return [(xs[i * bs:(i + 1) * bs], ys[i * bs:(i + 1) * bs])
            for i in range(len(xs) // bs)]


def run(root: str = "exp_vad", num_train: int = 24, num_test: int = 8,
        init_params: Optional[Mapping[str, torch.Tensor]] = None,
        device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """Energy, GMM and DNN VADs on the synthetic corpus; writes
    ``segment.info`` and ``u0.TextGrid`` (the first test utterance's
    DNN segments) under ``root``; returns JAX's dict of AUCs, EERs and
    ``num_segments``."""
    os.makedirs(root, exist_ok=True)
    device = resolve_device(device)
    train_wavs, train_labels = synthesize(num_train, seed=777)
    test_wavs, test_labels = synthesize(num_test, seed=778)

    fo = FrameExtractionOptions(samp_freq=SAMP_FREQ, dither=0.0)
    fbank = Fbank(frame_opts=fo, device=device)
    train_f, train_l = featurize(fbank, train_wavs, train_labels)
    test_f, test_l = featurize(fbank, test_wavs, test_labels)
    tr_feats = np.concatenate(train_f)
    tr_lab = np.concatenate(train_l)
    te_lab = np.concatenate(test_l)
    cmn = tr_feats.mean(axis=0)

    results: Dict[str, float] = {}

    # --- energy VAD (run_energy_vad.sh)
    evad = EnergyVad(VadOptions(), device=device)
    shift, wlen = int(SAMP_FREQ * 0.01), int(SAMP_FREQ * 0.025)

    def wav_frames(w, n):
        return np.stack([w[i * shift:i * shift + wlen]
                         for i in range(n)])

    e_scores = np.concatenate([
        evad.frame_scores(wav_frames(w, len(l)))
        for w, l in zip(test_wavs, test_l)])
    results["energy_auc"] = auc(e_scores, te_lab)
    results["energy_eer"] = eer(e_scores, te_lab)

    # --- GMM VAD (run_gmm_vad.sh / train_diag_gmm.sh)
    gvad = train_gmm_vad(tr_feats - cmn, tr_lab, num_gauss=16,
                         num_iters=10, device=device)
    g_scores = np.concatenate([gvad.frame_scores(f - cmn)
                               for f in test_f])
    results["gmm_auc"] = auc(g_scores, te_lab)
    results["gmm_eer"] = eer(g_scores, te_lab)

    # --- DNN VAD (run_dnn_vad.sh): sil/speech softmax
    net = build_net(tr_feats.shape[1])
    init_net(net, init_params)
    net.to(device)
    velocity = init_velocity(net)
    trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.9),
                           objective="xent")
    rng = np.random.RandomState(0)
    order = rng.permutation(len(tr_feats))
    xs, ys = (tr_feats - cmn)[order], tr_lab[order]
    for epoch in range(3):
        velocity, rep = trainer.train_epoch(
            velocity, frame_batches(xs, ys), 0.05)
        logger.info("dnn epoch %d %s", epoch + 1,
                    rep.report().replace("\n", " "))
    nvad = NnetVad(VadOptions(sil_pdf_ids="0"))
    test_post = [posteriors(net, f - cmn, device) for f in test_f]
    post = np.concatenate(test_post)
    # score = speech posterior = 1 - sil posterior
    results["dnn_auc"] = auc(post[:, 1], te_lab)
    results["dnn_eer"] = eer(post[:, 1], te_lab)

    # --- segmentation + TextGrid on the first test utterance
    mask = nvad.detect_from_posteriors(test_post[0])
    intervals = mask_to_intervals(mask)
    with open(os.path.join(root, "segment.info"), "w") as f:
        for s, e in intervals:
            f.write("[%d, %d]\n" % (s, e))
    if intervals:
        tg = intervals_to_textgrid(intervals, tier_name="u0")
        with open(os.path.join(root, "u0.TextGrid"), "w") as f:
            f.write(tg)
    results["num_segments"] = float(len(intervals))

    run.artifacts = dict(
        net=net, cmn=cmn, gmm_vad=gvad, train_feats=train_f,
        train_labels=train_l, test_feats=test_f, test_labels=test_l,
        test_wavs=test_wavs, test_posteriors=test_post,
        e_scores=e_scores, g_scores=g_scores)
    for k, v in sorted(results.items()):
        logger.info("%s = %.4f", k, v)
    return results


if __name__ == "__main__":
    argv = sys.argv[1:]
    dev = next((a.split("=", 1)[1] for a in argv
                if a.startswith("--device=")), "cuda")
    pos = [a for a in argv if not a.startswith("--")]
    print("RESULT", run(pos[0] if pos else "exp_vad", device=dev))
