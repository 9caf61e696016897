"""NN CLI mains: model tools, the network forwards, alignment and matrix
tools, WER scoring and noise augmentation.

Port of kaldi_aslp_tpu/cli/nnet_tools.py (reference:
src/aslp-nnetbin/aslp-nnet-{init,info,copy,dot,forward,forward-mimo,
insert,convert-to-standard}.cc, src/bin/ali-to-pdf.cc, analyze-counts.cc,
compute-wer.cc, src/aslp-bin/aslp-{ali-minus-one,ali-to-matrix,
matrix-to-txt,txt-to-matrix,copy-vector-from-matrix,
extract-transition-to-pdf,wav-noise}.cc):

    aslp-nnet-init [--seed=777] [--device=cuda] proto model-out
    aslp-nnet-info [--device=cuda] model
    aslp-nnet-copy [--device=cuda] model-in model-out
    aslp-nnet-dot [--device=cuda] model [dot-out]
    aslp-nnet-forward [--device=cuda] model feats-rspec loglikes-wspec
    aslp-nnet-forward-mimo [--device=cuda] model feats-rspec-1 ..
        feats-rspec-N out-wspec
    aslp-nnet-insert [--position=-1] [--device=cuda] base insert out
    aslp-nnet-convert-to-standard [--device=cuda] in out
    ali-to-pdf tid-to-pdf.txt ali-rspec pdf-wspec
    aslp-ali-minus-one / analyze-counts / aslp-ali-to-matrix /
    aslp-matrix-to-txt / aslp-txt-to-matrix /
    aslp-copy-vector-from-matrix / aslp-extract-transition-to-pdf
    compute-wer [--mode=present] ark:ref.txt ark:hyp.txt
    aslp-wav-noise [--snr-db=20] [--seed=777] scp:wav.scp out_dir

Every tool that builds or runs a net takes ``--device`` (default
``cuda``; without CUDA it raises rather than run on the CPU) and reads
and writes the JAX package's model zip.  ``aslp-nnet-init`` draws the
parameters from a ``torch.Generator`` seeded ``--seed`` on the CPU, so
the card and the CPU write the same model; the draws are not JAX's.
``aslp-nnet-insert`` re-draws the next affine from one seeded
``--srand-seed`` likewise.  ``aslp-nnet-convert-to-standard`` checks that
the net is a plain chain and writes it without DAG metadata, in the zip
format, as the JAX tool does; ``models/kaldi_import.py`` reads and writes
the reference's own .nnet files.  ``aslp-extract-transition-to-pdf``
reads a pickle of the port's ``TransitionModel`` (a JAX pickle names the
JAX package's classes).  As in the JAX package, the ``-skip`` and
``-blstm-lc`` forwards are the same main: the frame skip is
``--skip-width``, the architecture lives in the model file.
``aslp-wav-noise`` is host numpy: white noise from a
``RandomState(seed)`` mixed in at ``--snr-db`` by feats/resample.py's
``add_noise``, one wav an utterance in ``out_dir``."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config, parse_options
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("cli")


@dataclasses.dataclass
class DeviceFlags(Config):
    device: str = "cuda"


def _load(path: str, device: str):
    """(net, states) of a model zip on ``--device``."""
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    return Nnet.load(path, resolve_device(device))


def nnet_init(argv) -> int:
    import torch

    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    @dataclasses.dataclass
    class Flags(DeviceFlags):
        seed: int = 777

    flags = Flags()
    args = parse_options(
        argv, [flags], "aslp-nnet-init [--device=cuda] proto-file "
        "model-out", 2, 2)
    with open(args[0]) as f:
        net = Nnet.from_proto(f.read())
    net.reset_parameters(torch.Generator().manual_seed(flags.seed))
    net.to(resolve_device(flags.device))
    net.save(args[1])
    logger.info("initialized %d components, %d params",
                net.num_components(), net.num_params())
    return 0


def nnet_info(argv) -> int:
    flags = DeviceFlags()
    args = parse_options(argv, [flags], "aslp-nnet-info model", 1, 1)
    net, _ = _load(args[0], flags.device)
    print(net.info(with_params=True))
    return 0


def nnet_copy(argv) -> int:
    flags = DeviceFlags()
    args = parse_options(argv, [flags], "aslp-nnet-copy in out", 2, 2)
    net, states = _load(args[0], flags.device)
    net.save(args[1], states)
    return 0


def nnet_dot(argv) -> int:
    flags = DeviceFlags()
    args = parse_options(argv, [flags], "aslp-nnet-dot model [dot-out]",
                         1, 2)
    net, _ = _load(args[0], flags.device)
    dot = net.to_dot()
    if len(args) > 1:
        with open(args[1], "w") as f:
            f.write(dot)
    else:
        print(dot)
    return 0


def nnet_forward_cli(argv) -> int:
    from kaldi_aslp_tpu_torch.decoder.decodable import (
        NnetForwardOptions,
        PdfPrior,
        nnet_forward,
    )
    from kaldi_aslp_tpu_torch.io import matrix_writer, sequential_matrix_reader

    opts = NnetForwardOptions()

    @dataclasses.dataclass
    class Flags(DeviceFlags):
        class_frame_counts: str = ""
        prior_scale: float = 1.0

    flags = Flags()
    args = parse_options(
        argv, [opts, flags],
        "aslp-nnet-forward [--device=cuda] model feats-rspec "
        "loglikes-wspec", 3, 3)
    net, _ = _load(args[0], flags.device)
    prior = None
    if flags.class_frame_counts:
        counts = np.loadtxt(flags.class_frame_counts)
        prior = PdfPrior(counts, prior_scale=flags.prior_scale)
    with matrix_writer(args[2]) as w:
        for utt, feats in sequential_matrix_reader(args[1]):
            w[utt] = nnet_forward(net, feats, opts, prior)
    return 0


def nnet_forward_mimo(argv) -> int:
    """MIMO forward (reference: aslp-nnetbin/aslp-nnet-forward-mimo.cc):
    N feature rspecifiers, N the net's inputs (:75-79), and one output
    wspecifier; a multi-output net writes its LAST output (:143-146).
    The readers advance in lock step and must agree on keys (:120-125)."""
    import torch

    from kaldi_aslp_tpu_torch.decoder.decodable import (
        NnetForwardOptions,
        PdfPrior,
    )
    from kaldi_aslp_tpu_torch.io import matrix_writer, sequential_matrix_reader

    opts = NnetForwardOptions()

    @dataclasses.dataclass
    class Flags(DeviceFlags):
        class_frame_counts: str = ""
        prior_scale: float = 1.0

    flags = Flags()
    args = parse_options(
        argv, [opts, flags],
        "aslp-nnet-forward-mimo [--device=cuda] model feats-rspec-1 ... "
        "feats-rspec-N out-wspec", 3, 66)
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    device = resolve_device(flags.device)
    net, _ = _load(args[0], flags.device)
    n_in = net.num_inputs
    if len(args) != 1 + n_in + 1:
        print(f"aslp-nnet-forward-mimo: net has {n_in} input(s); "
              f"expected {1 + n_in + 1} args (model + {n_in} feature "
              f"rspecifiers + out-wspec), got {len(args)}",
              file=sys.stderr)
        return 1
    prior = None
    if flags.class_frame_counts:
        prior = PdfPrior(np.loadtxt(flags.class_frame_counts),
                         prior_scale=flags.prior_scale)
    readers = [sequential_matrix_reader(a) for a in args[1:1 + n_in]]
    net.eval()
    num_done = 0
    with matrix_writer(args[-1]) as w, torch.no_grad():
        for items in zip(*readers):
            utt = items[0][0]
            for utti, _ in items[1:]:
                if utti != utt:
                    print(f"aslp-nnet-forward-mimo: key mismatch "
                          f"{utt} vs {utti}; check feature scp order",
                          file=sys.stderr)
                    return 1
            xs = []
            for _, mat in items:
                x = np.asarray(mat, np.float32)
                if opts.time_shift > 0:
                    x = np.concatenate(
                        [x[opts.time_shift:],
                         np.repeat(x[-1:], opts.time_shift, 0)])
                xs.append(torch.from_numpy(np.array(x[None])).to(device))
            ys, _ = net(xs if n_in > 1 else xs[0])
            y = (ys[-1] if isinstance(ys, list) else ys)[0]
            if not opts.no_softmax:
                y = torch.log_softmax(y, dim=-1)
            elif opts.apply_log:
                y = torch.log(torch.clamp(y, min=1e-20))
            if prior is not None:
                y = prior.subtract(y)
            w[utt] = y.cpu().numpy()
            num_done += 1
    logger.info("forwarded %d utterances", num_done)
    return 0


def nnet_insert(argv) -> int:
    """Insert another net's chain into a net (reference:
    aslp-nnetbin/aslp-nnet-insert.cc:14-49 InsertComponents): by default
    before the last updatable component, with the next affine re-drawn
    (the pretrain.sh growth step); ``--position`` < 0 is the reference's
    ``--insert-at`` < 0."""
    import torch

    from kaldi_aslp_tpu_torch.train.pretrain import insert_components

    @dataclasses.dataclass
    class Flags(DeviceFlags):
        position: int = -1
        randomize_next_component: bool = True
        stddev_factor: float = 0.1
        srand_seed: int = 0

    flags = Flags()
    args = parse_options(
        argv, [flags], "aslp-nnet-insert base.knet insert.knet out.knet",
        3, 3)
    base, _ = _load(args[0], flags.device)
    ins, _ = _load(args[1], flags.device)
    try:
        out = insert_components(
            base, ins, insert_at=int(flags.position),
            randomize_next=bool(flags.randomize_next_component),
            stddev_factor=float(flags.stddev_factor),
            generator=torch.Generator().manual_seed(int(flags.srand_seed)))
    except ValueError as e:
        print(f"aslp-nnet-insert: {e}", file=sys.stderr)
        return 1
    out.save(args[2])
    print(f"Inserted {len(ins.nodes)} components", file=sys.stderr)
    return 0


def nnet_convert_to_standard(argv) -> int:
    """Graph net -> plain chain (reference:
    aslp-nnetbin/aslp-nnet-convert-to-standard.cc, Nnet::WriteStandard
    nnet-nnet.h:143): a net that is not a simple chain is refused; the
    output holds the components without DAG metadata (and no state)."""
    from kaldi_aslp_tpu_torch.models import Nnet

    flags = DeviceFlags()
    args = parse_options(
        argv, [flags], "aslp-nnet-convert-to-standard in.knet out.knet",
        2, 2)
    net, _ = _load(args[0], flags.device)
    chain = Nnet()
    for i, (comp, edges) in enumerate(zip(net.nodes, net.node_inputs)):
        want = [("in:0", 0)] if i == 0 else [(i - 1, 0)]
        if [tuple(e) for e in edges] != want:
            print("aslp-nnet-convert-to-standard: net is not a simple "
                  "chain (MIMO/branching graph)", file=sys.stderr)
            return 1
        chain.add(comp)
    chain.save(args[1])
    print(f"Converted {len(net.nodes)} components", file=sys.stderr)
    return 0


def ali_to_pdf(argv) -> int:
    """Transition ids to pdf ids by a tid -> pdf table (one int a line,
    as ``aslp-extract-transition-to-pdf`` writes it)."""
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        sequential_int_vector_reader,
    )

    args = parse_options(
        argv, [], "ali-to-pdf tid-to-pdf.txt ali-rspec pdf-wspec", 3, 3)
    lut = np.loadtxt(args[0], dtype=np.int32)
    with int_vector_writer(args[2]) as w:
        for utt, ali in sequential_int_vector_reader(args[1]):
            w[utt] = lut[ali]
    return 0


def ali_minus_one(argv) -> int:
    """(reference: aslp-bin/aslp-ali-minus-one.cc) every label minus one,
    so that blank becomes 0 for CTC."""
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        sequential_int_vector_reader,
    )

    args = parse_options(argv, [],
                         "aslp-ali-minus-one in-rspec out-wspec", 2, 2)
    with int_vector_writer(args[1]) as w:
        for utt, ali in sequential_int_vector_reader(args[0]):
            w[utt] = np.asarray(ali) - 1
    return 0


def analyze_counts(argv) -> int:
    """Label counts over an alignment table, one text row of
    ``--num-classes`` (or more, up to the largest label) floats."""
    from kaldi_aslp_tpu_torch.io import sequential_int_vector_reader

    @dataclasses.dataclass
    class Flags(Config):
        num_classes: int = 0

    flags = Flags()
    args = parse_options(
        argv, [flags], "analyze-counts ali-rspec counts-out", 2, 2)
    counts = np.zeros(max(flags.num_classes, 1), np.float64)
    for _, ali in sequential_int_vector_reader(args[0]):
        m = int(np.max(ali)) + 1 if len(ali) else 0
        if m > len(counts):
            counts = np.concatenate([counts, np.zeros(m - len(counts))])
        np.add.at(counts, np.asarray(ali), 1.0)
    np.savetxt(args[1], counts[None], fmt="%.1f")
    return 0


def ali_to_matrix(argv) -> int:
    """Alignment -> one-hot rows of ``--dict-size`` columns (reference:
    aslp-bin/aslp-ali-to-matrix.cc)."""
    from kaldi_aslp_tpu_torch.io import (
        matrix_writer,
        sequential_int_vector_reader,
    )

    @dataclasses.dataclass
    class Flags(Config):
        dict_size: int = 0

    flags = Flags()
    args = parse_options(
        argv, [flags],
        "aslp-ali-to-matrix --dict-size=N ali-rspec mat-wspec", 2, 2)
    if flags.dict_size <= 0:
        print("--dict-size required", file=sys.stderr)
        return 1
    n = 0
    with matrix_writer(args[1]) as w:
        for utt, ali in sequential_int_vector_reader(args[0]):
            ali = np.asarray(ali)
            if ali.size and (ali.min() < 0
                             or ali.max() >= flags.dict_size):
                print(f"{utt}: label outside [0, {flags.dict_size})",
                      file=sys.stderr)
                return 1
            m = np.zeros((len(ali), flags.dict_size), np.float32)
            m[np.arange(len(ali)), ali] = 1.0
            w[utt] = m
            n += 1
    print(f"Converted {n} alignments", file=sys.stderr)
    return 0


def matrix_to_txt(argv) -> int:
    """Matrix table -> text: the key, then one line a row (reference:
    aslp-bin/aslp-matrix-to-txt.cc)."""
    from kaldi_aslp_tpu_torch.io import sequential_matrix_reader

    args = parse_options(
        argv, [], "aslp-matrix-to-txt mat-rspec out.txt", 2, 2)
    with open(args[1], "w") as f:
        for utt, mat in sequential_matrix_reader(args[0]):
            f.write(utt + "\n")
            for row in np.asarray(mat):
                f.write(" ".join(f"{v:g}" for v in row) + "\n")
    return 0


def txt_to_matrix(argv) -> int:
    """Text -> matrix table: blocks separated by blank lines, each a key
    line and then one line a row (reference:
    aslp-bin/aslp-txt-to-matrix.cc)."""
    from kaldi_aslp_tpu_torch.io import matrix_writer

    args = parse_options(
        argv, [], "aslp-txt-to-matrix in.txt mat-wspec", 2, 2)
    with open(args[0]) as f, matrix_writer(args[1]) as w:
        key, rows = None, []
        for line in list(f) + [""]:
            line = line.strip()
            if not line:
                if key is not None and rows:
                    w[key] = np.asarray(rows, np.float32)
                key, rows = None, []
            elif key is None:
                key = line
            else:
                rows.append([float(x) for x in line.split()])
    return 0


def copy_vector_from_matrix(argv) -> int:
    """Column ``--column`` of each matrix as a vector table (reference:
    aslp-bin/aslp-copy-vector-from-matrix.cc)."""
    from kaldi_aslp_tpu_torch.io import sequential_matrix_reader, vector_writer

    @dataclasses.dataclass
    class Flags(Config):
        column: int = 0

    flags = Flags()
    args = parse_options(
        argv, [flags],
        "aslp-copy-vector-from-matrix mat-rspec vec-wspec", 2, 2)
    with vector_writer(args[1]) as w:
        for utt, mat in sequential_matrix_reader(args[0]):
            w[utt] = np.asarray(mat)[:, flags.column]
    return 0


def extract_transition_to_pdf(argv) -> int:
    """The tid -> pdf table of a pickled transition model as text, one
    pdf a line from transition id 0 (reference:
    aslp-bin/aslp-extract-transition-to-pdf.cc)."""
    import pickle

    args = parse_options(
        argv, [], "aslp-extract-transition-to-pdf mdl.pkl tid2pdf.txt",
        2, 2)
    with open(args[0], "rb") as f:
        tm = pickle.load(f)
    lut = tm.alignment_to_pdfs(np.arange(tm.num_transition_ids + 1))
    np.savetxt(args[1], np.asarray(lut).reshape(-1, 1), fmt="%d")
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
