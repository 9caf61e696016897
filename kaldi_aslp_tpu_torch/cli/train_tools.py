"""Training CLI mains.

Port of ``nnet_train_ctc_streams`` from kaldi_aslp_tpu/cli/train_tools.py
(reference: src/aslp-nnetbin/aslp-nnet-train-ctc-streams.cc):

    aslp-nnet-train-ctc-streams [--device=cuda] feats-rspec labels-rspec
        model-in [model-out]

reads features and CTC label sequences from Kaldi tables, batches them
with ``CtcBatcher``, runs one epoch of momentum SGD (or, with
``--cross-validate``, only the loss) on ``--device`` (default ``cuda``;
on a machine without CUDA it raises rather than run on the CPU), writes
the model in the JAX package's zip format, and prints the "AvgLoss:"
report.

Unlike the JAX tool, the features are not cut to the length of the label
sequence (the JAX tool shares the frame trainer's source, which aligns
frame targets; for CTC that cut drops every utterance), and the l1 and
l2 penalties reach the update."""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config, parse_options
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("train-cli")

CTC_USAGE = ("aslp-nnet-train-ctc-streams [--device=cuda] feats-rspec "
             "labels-rspec model-in [model-out]")


@dataclasses.dataclass
class TrainerFlags(Config):
    learn_rate: float = 0.008
    momentum: float = 0.0
    l1_penalty: float = 0.0
    l2_penalty: float = 0.0
    cross_validate: bool = False
    device: str = "cuda"


def ctc_source(feats_rspec: str, labels_rspec: str):
    """(key, feats [T, D], labels [U]) for every utterance with labels."""
    from kaldi_aslp_tpu_torch.io import (
        random_access_int_vector_reader,
        sequential_matrix_reader,
    )

    labels = random_access_int_vector_reader(labels_rspec)
    for utt, feats in sequential_matrix_reader(feats_rspec):
        if utt not in labels:
            logger.warning("no labels for %s, skipping", utt)
            continue
        yield utt, feats, np.asarray(labels[utt])


def nnet_train_ctc_streams(argv) -> int:
    from kaldi_aslp_tpu_torch.data.sequence import (
        CtcBatcher,
        CtcBatcherOptions,
    )
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.train import (
        CtcTrainer,
        NnetTrainOptions,
        init_velocity,
    )
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    flags = TrainerFlags()
    bopts = CtcBatcherOptions()
    args = parse_options(argv, [flags, bopts], CTC_USAGE, 3, 4)
    device = resolve_device(flags.device)
    net, states = Nnet.load(args[2], device)
    trainer = CtcTrainer(net, NnetTrainOptions(
        learn_rate=flags.learn_rate, momentum=flags.momentum,
        l1_penalty=flags.l1_penalty, l2_penalty=flags.l2_penalty))
    batches = CtcBatcher(ctc_source(args[0], args[1]), bopts)
    if flags.cross_validate:
        rep = trainer.evaluate(batches)
    else:
        _, rep = trainer.train_epoch(init_velocity(net), batches,
                                     flags.learn_rate)
        if len(args) > 3:
            net.save(args[3], states)
    print(rep.report())
    return 0
