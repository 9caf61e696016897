"""Training CLI mains.

Port of ``nnet_train_simple``, ``nnet_train_frame_mimo``,
``nnet_train_ctc_streams`` and ``nnet_train_lstm_streams`` from
kaldi_aslp_tpu/cli/train_tools.py (reference:
src/aslp-nnetbin/aslp-nnet-train-simple.cc,
aslp-nnet-train-frame-mimo.cc, aslp-nnet-train-ctc-streams.cc and
aslp-nnet-train-lstm-streams.cc):

    aslp-nnet-train-simple [--device=cuda] feats-rspec targets-rspec
        model-in [model-out]
    aslp-nnet-train-frame-mimo [--device=cuda]
        [--objective-function=xent:mse] feats-rspec-1 .. feats-rspec-N
        targets-rspec-1 .. targets-rspec-M model-in [model-out]
    aslp-nnet-train-ctc-streams [--device=cuda] feats-rspec
        labels-rspec model-in [model-out]
    aslp-nnet-train-lstm-streams [--device=cuda] feats-rspec
        targets-rspec model-in [model-out]

Each reads features and targets from Kaldi tables, runs one epoch of
momentum SGD (or, with ``--cross-validate``, only the loss, in ``eval()``
mode with no update) on ``--device`` (default ``cuda``; on a machine
without CUDA it raises rather than run on the CPU), writes the model in
the JAX package's zip format, and prints the "AvgLoss:" report.  The
frame tools shuffle frames with ``FrameRandomizer`` (its pool and
minibatch flags); the MIMO tool takes one objective an output, its xent
targets as int vectors and its mse targets as matrices, and one report
an output ("[output k] AvgLoss: ..."); the CTC tool batches whole
utterances with ``CtcBatcher``; the BPTT tool cuts multi-stream chunks with
``SequenceDataReader`` and carries the state across them.

Where the JAX tools differ, and the port does not follow:
  - the JAX CTC tool cuts the features to the length of the label
    sequence (it shares the frame trainers' source, which aligns frame
    targets; for CTC that cut drops every utterance); the port cuts only
    in the BPTT tool, whose targets are per frame;
  - the JAX tools pass only the learning rate and momentum to the update;
    the port passes the l1 and l2 penalties too;
  - the JAX BPTT tool's cross-validation still updates the parameters
    chunk by chunk (only the save is skipped); the port's evaluates;
  - the JAX frame tool with ``--objective-function=mse`` subtracts the
    alignment's pdf ids from the [N, P] outputs, which fails to
    broadcast; the port's takes them as one-hot rows of the output's
    width, as the reference turns an alignment into a target matrix
    (PosteriorToMatrix);
  - the JAX frame tools hand a net the [N, D] minibatch, which a
    recurrent component, cFSMN or RowConvolution cannot unpack; the
    port's give such a net N streams of one frame (``FrameTrainer``);
  - the JAX BPTT tools pass the net no PRNG key, so a ``Dropout`` there
    drops nothing in training; the port's draw its masks, as the
    reference's trainer does."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config, parse_options
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("train-cli")

CTC_USAGE = ("aslp-nnet-train-ctc-streams [--device=cuda] feats-rspec "
             "labels-rspec model-in [model-out]")
FRAME_USAGE = ("aslp-nnet-train-simple [--device=cuda] feats-rspec "
               "targets-rspec model-in [model-out]")
MIMO_USAGE = ("aslp-nnet-train-frame-mimo [--device=cuda] feats-rspec-1..N "
              "targets-rspec-1..M model-in [model-out]")
LSTM_USAGE = ("aslp-nnet-train-lstm-streams [--device=cuda] feats-rspec "
              "targets-rspec model-in [model-out]")


@dataclasses.dataclass
class TrainerFlags(Config):
    learn_rate: float = 0.008
    momentum: float = 0.0
    l1_penalty: float = 0.0
    l2_penalty: float = 0.0
    cross_validate: bool = False
    device: str = "cuda"


@dataclasses.dataclass
class FrameTrainerFlags(TrainerFlags):
    objective_function: str = "xent"


@dataclasses.dataclass
class MimoTrainerFlags(FrameTrainerFlags):
    seed: int = 777


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


def frame_source(feats_rspec: str, targets_rspec: str):
    """(key, feats [n, D], targets [n]) for every utterance with targets,
    both cut to the shorter of the two (kaldi_aslp_tpu/cli/
    train_tools.py:51-59)."""
    from kaldi_aslp_tpu_torch.io import (
        random_access_int_vector_reader,
        sequential_matrix_reader,
    )

    targets = random_access_int_vector_reader(targets_rspec)
    for utt, feats in sequential_matrix_reader(feats_rspec):
        if utt not in targets:
            logger.warning("no targets for %s, skipping", utt)
            continue
        tgt = np.asarray(targets[utt])
        n = min(len(feats), len(tgt))
        yield utt, feats[:n], tgt[:n]


def _train_options(flags: TrainerFlags):
    from kaldi_aslp_tpu_torch.train import NnetTrainOptions

    return NnetTrainOptions(learn_rate=flags.learn_rate,
                            momentum=flags.momentum,
                            l1_penalty=flags.l1_penalty,
                            l2_penalty=flags.l2_penalty)


def nnet_train_simple(argv) -> int:
    """Frame-shuffled cross-entropy or MSE trainer (reference:
    aslp-nnet-train-simple.cc); also aslp-nnet-train-mse and
    aslp-nnet-train-frame."""
    from kaldi_aslp_tpu_torch.data.randomizer import (
        FrameRandomizer,
        RandomizerOptions,
    )
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.train import FrameTrainer, init_velocity
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    flags = FrameTrainerFlags()
    ropts = RandomizerOptions()
    args = parse_options(argv, [flags, ropts], FRAME_USAGE, 3, 4)
    device = resolve_device(flags.device)
    net, states = Nnet.load(args[2], device)
    trainer = FrameTrainer(net, _train_options(flags),
                           objective=flags.objective_function)

    def batches():
        r = FrameRandomizer(ropts)
        for _, f, t in frame_source(args[0], args[1]):
            r.feed(f, t)
            if r.full():
                yield from r.iterate_minibatches()
        yield from r.flush()

    t0 = time.perf_counter()
    if flags.cross_validate:
        rep = trainer.evaluate(batches())
    else:
        _, rep = trainer.train_epoch(init_velocity(net), batches(),
                                     flags.learn_rate)
        if len(args) > 3:
            net.save(args[3], states)
    print(rep.report())
    logger.info("done in %.1fs (%s)", time.perf_counter() - t0,
                "CV" if flags.cross_validate else "train")
    return 0


def nnet_train_frame_mimo(argv) -> int:
    """MIMO frame trainer (reference: aslp-nnet-train-frame-mimo.cc): N
    feature rspecifiers, M target rspecifiers, model-in and, unless
    ``--cross-validate``, model-out, with N and M the net's inputs and
    outputs (:82-94); ``--objective-function`` names one objective an
    output, colon-separated, e.g. "xent:mse" (:104-111).  One update a
    minibatch on the sum of the outputs' losses, by ``FrameTrainer``;
    ``Dropout`` draws from its generator, seeded ``--seed``."""
    import sys

    from kaldi_aslp_tpu_torch.data.randomizer import (
        FrameRandomizer,
        RandomizerOptions,
    )
    from kaldi_aslp_tpu_torch.io import (
        random_access_int_vector_reader,
        random_access_matrix_reader,
        sequential_matrix_reader,
    )
    from kaldi_aslp_tpu_torch.models import LossReporter, Nnet
    from kaldi_aslp_tpu_torch.train import FrameTrainer, init_velocity
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    flags = MimoTrainerFlags()
    ropts = RandomizerOptions()
    args = parse_options(argv, [flags, ropts], MIMO_USAGE, 2, 66)
    extra = 1 if flags.cross_validate else 2
    device = resolve_device(flags.device)
    net, states = Nnet.load(args[-extra], device)
    n_in, n_out = net.num_inputs, len(net.output_ids())
    if len(args) != n_in + n_out + extra:
        print(f"aslp-nnet-train-frame-mimo: net has {n_in} input(s) / "
              f"{n_out} output(s); expected {n_in + n_out + extra} args, "
              f"got {len(args)}", file=sys.stderr)
        return 1
    objectives = flags.objective_function.split(":")
    if len(objectives) != n_out:
        print(f"aslp-nnet-train-frame-mimo: --objective-function needs "
              f"{n_out} colon-separated entries, got "
              f"{flags.objective_function!r}", file=sys.stderr)
        return 1
    for obj in objectives:
        if obj not in ("xent", "mse"):
            print(f"unknown objective {obj!r}", file=sys.stderr)
            return 1
    feat_specs = args[:n_in]
    tgt_readers = [
        (random_access_int_vector_reader(spec) if obj == "xent"
         else random_access_matrix_reader(spec))
        for spec, obj in zip(args[n_in:n_in + n_out], objectives)]

    def utterances():
        """The N feature readers in lock step, the targets by key."""
        for items in zip(*[sequential_matrix_reader(s) for s in feat_specs]):
            utt = items[0][0]
            if any(u != utt for u, _ in items[1:]):
                raise RuntimeError(
                    f"feature key mismatch at {utt}; check scp order")
            if any(utt not in r for r in tgt_readers):
                logger.warning("no targets for %s, skipping", utt)
                continue
            feats = [np.asarray(m, np.float32) for _, m in items]
            tgts = [np.asarray(r[utt]) for r in tgt_readers]
            n = min(min(len(f) for f in feats), min(len(t) for t in tgts))
            yield [f[:n] for f in feats], [t[:n] for t in tgts]

    def minibatches():
        r = FrameRandomizer(ropts)
        for feats, tgts in utterances():
            r.feed(*feats, *tgts)
            if r.full():
                yield from r.iterate_minibatches()
        yield from r.flush()

    trainer = FrameTrainer(net, _train_options(flags),
                           objective=flags.objective_function,
                           seed=flags.seed)
    reporters = [LossReporter(obj) for obj in objectives]
    if flags.cross_validate:
        trainer.evaluate(minibatches(), reporters)
    else:
        trainer.train_epoch(init_velocity(net), minibatches(),
                            flags.learn_rate, reporters)
    for i, rep in enumerate(reporters):
        print(f"[output {i}] {rep.report()}")
    if not flags.cross_validate:
        net.save(args[-1], states)
    return 0


def nnet_train_ctc_streams(argv) -> int:
    from kaldi_aslp_tpu_torch.data.sequence import (
        CtcBatcher,
        CtcBatcherOptions,
    )
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.train import CtcTrainer, init_velocity
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    flags = TrainerFlags()
    bopts = CtcBatcherOptions()
    args = parse_options(argv, [flags, bopts], CTC_USAGE, 3, 4)
    device = resolve_device(flags.device)
    net, states = Nnet.load(args[2], device)
    trainer = CtcTrainer(net, _train_options(flags))
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


def nnet_train_lstm_streams(argv) -> int:
    """BPTT chunk trainer (reference: aslp-nnet-train-lstm-streams.cc):
    multi-stream chunks with carried state and frame-level cross-entropy
    targets."""
    from kaldi_aslp_tpu_torch.data.sequence import (
        SequenceDataReader,
        SequenceReaderOptions,
    )
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.train import LstmStreamsTrainer, init_velocity
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    flags = TrainerFlags()
    sopts = SequenceReaderOptions()
    args = parse_options(argv, [flags, sopts], LSTM_USAGE, 3, 4)
    device = resolve_device(flags.device)
    net, states = Nnet.load(args[2], device)
    trainer = LstmStreamsTrainer(net, _train_options(flags))
    chunks = SequenceDataReader(frame_source(args[0], args[1]), sopts)
    if flags.cross_validate:
        rep = trainer.evaluate(chunks, sopts.num_streams)
    else:
        _, rep = trainer.train_epoch(init_velocity(net), chunks,
                                     flags.learn_rate, sopts.num_streams)
        if len(args) > 3:
            net.save(args[3], states)
    print(rep.report())
    return 0
