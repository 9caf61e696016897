"""NN CLI mains: the network forward, WER scoring and noise
augmentation.

Port of ``nnet_forward_cli``, ``compute_wer`` and ``wav_noise`` from
kaldi_aslp_tpu/cli/nnet_tools.py (reference:
src/aslp-nnetbin/aslp-nnet-forward.cc, src/bin/compute-wer.cc,
src/aslp-bin/aslp-wav-noise.cc):

    aslp-nnet-forward [--device=cuda] model feats-rspec loglikes-wspec
    compute-wer [--mode=present] ark:ref.txt ark:hyp.txt
    aslp-wav-noise [--snr-db=20] [--seed=777] scp:wav.scp out_dir

``aslp-nnet-forward`` loads the JAX package's model zip and writes
log-posteriors (minus the log prior of ``--class-frame-counts``, scaled
by ``--prior-scale``) for every utterance, computed on ``--device``
(default ``cuda``; without CUDA it raises rather than run on the CPU).
As in the JAX package, the ``-skip`` and ``-blstm-lc`` binaries are the
same main: the frame skip is ``--skip-width``, the architecture lives in
the model file.  ``aslp-wav-noise`` is host numpy, as in the JAX
package: white noise from a ``RandomState(seed)`` mixed in at
``--snr-db`` by feats/resample.py's ``add_noise``, one wav an
utterance in ``out_dir``."""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config, parse_options


def nnet_forward_cli(argv) -> int:
    from kaldi_aslp_tpu_torch.decoder.decodable import (
        NnetForwardOptions,
        PdfPrior,
        nnet_forward,
    )
    from kaldi_aslp_tpu_torch.io import matrix_writer, sequential_matrix_reader
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    opts = NnetForwardOptions()

    @dataclasses.dataclass
    class Flags(Config):
        class_frame_counts: str = ""
        prior_scale: float = 1.0
        device: str = "cuda"

    flags = Flags()
    args = parse_options(
        argv, [opts, flags],
        "aslp-nnet-forward [--device=cuda] model feats-rspec "
        "loglikes-wspec", 3, 3)
    net, _ = Nnet.load(args[0], resolve_device(flags.device))
    prior = None
    if flags.class_frame_counts:
        counts = np.loadtxt(flags.class_frame_counts)
        prior = PdfPrior(counts, prior_scale=flags.prior_scale)
    with matrix_writer(args[2]) as w:
        for utt, feats in sequential_matrix_reader(args[1]):
            w[utt] = nnet_forward(net, feats, opts, prior)
    return 0


def compute_wer(argv) -> int:
    @dataclasses.dataclass
    class Flags(Config):
        mode: str = "present"

    flags = Flags()
    args = parse_options(
        argv, [flags], "compute-wer ark:ref.txt ark:hyp.txt", 2, 2)
    from kaldi_aslp_tpu_torch.io.datadir import read_key_value
    from kaldi_aslp_tpu_torch.ops.edit_distance import score_utterances

    def load(spec):
        path = spec.split(":", 1)[1]
        return {k: v.split() for k, v in read_key_value(path).items()}

    refs, hyps = load(args[0]), load(args[1])
    if flags.mode == "present":
        refs = {k: v for k, v in refs.items() if k in hyps}
    stats = score_utterances(refs, hyps)
    print(stats.report())
    print(f"%SER {stats.ser:.2f} [ {stats.num_wrong_sentences} / "
          f"{stats.num_sentences} ]")
    return 0


def wav_noise(argv) -> int:
    """Additive noise augmentation of wav files (reference:
    aslp-bin/aslp-wav-noise.cc)."""
    import os

    from kaldi_aslp_tpu_torch.feats.resample import add_noise
    from kaldi_aslp_tpu_torch.io import WaveData, read_wave, write_wave

    @dataclasses.dataclass
    class Flags(Config):
        snr_db: float = 20.0
        seed: int = 777

    flags = Flags()
    args = parse_options(
        argv, [flags], "aslp-wav-noise scp:wav.scp out_dir", 2, 2)
    _, path = args[0].split(":", 1)
    os.makedirs(args[1], exist_ok=True)
    rng = np.random.RandomState(flags.seed)
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 2:
                continue
            utt, wav_path = toks[0], toks[1]
            wav = read_wave(wav_path)
            noise = rng.randn(len(wav.data[0])).astype(np.float32)
            noisy = add_noise(wav.data[0], noise, snr_db=flags.snr_db)
            write_wave(os.path.join(args[1], f"{utt}.wav"),
                       WaveData(wav.samp_freq,
                                noisy[None, :].astype(np.float32)))
    return 0
