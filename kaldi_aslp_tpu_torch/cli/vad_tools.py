"""VAD, pitch and spectrum CLI tools (reference: src/aslp-vadbin/:
the VAD apply and eval tools, aslp-ali-to-sil, aslp-select-frames,
aslp-eval-vad-boundary, aslp-compute-spectrum-feats;
src/gmmbin/gmm-global-init-from-feats; src/featbin/
compute-kaldi-pitch-feats).

Port of kaldi_aslp_tpu/cli/vad_tools.py: the same arguments and the same
output text.  The tools that compute on tensors take ``--device``
(default ``cuda``) and compute there: ``aslp-apply-energy-vad`` (the
frames' log energies), ``aslp-apply-gmm-vad`` and ``aslp-eval-gmm-vad``
(the GMMs' log-likelihood ratios, float64), ``gmm-global-init-from-feats``
(its EM statistics, float64), pitch and the spectrogram.  The rest read
masks, posteriors or alignments and stay on the host, as the JAX tools
do in numpy: they take no ``--device``.  ``aslp-apply-energy-vad`` cuts
each waveform into non-overlapping windows of ``--frame-length-ms``, as
JAX's does.  ``aslp-compute-spectrum-feats`` refuses ``--dither`` other
than 0, as the feature tools do (cli/feat_tools.py): the JAX tool takes
the flag, default 1.0, and never dithers."""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_aslp_tpu_torch.cli.feat_tools import (
    DeviceFlags,
    iter_wavs,
    refuse_dither,
)
from kaldi_aslp_tpu_torch.utils.config import Config, parse_options
from kaldi_aslp_tpu_torch.vad import VadOptions


def compute_pitch_cli(argv) -> int:
    from kaldi_aslp_tpu_torch.feats.pitch import (
        PitchOptions,
        compute_pitch,
        postprocess_pitch,
    )
    from kaldi_aslp_tpu_torch.io import matrix_writer
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    popts = PitchOptions()

    @dataclasses.dataclass
    class Flags(Config):
        post_process: bool = True

    flags, dev_flags = Flags(), DeviceFlags()
    args = parse_options(
        argv, [popts, flags, dev_flags],
        "compute-kaldi-pitch-feats [--device=cuda] scp:wav.scp "
        "ark:pitch.ark", 2, 2)
    device = resolve_device(dev_flags.device)
    with matrix_writer(args[1]) as w:
        for utt, wav in iter_wavs(args[0]):
            popts.samp_freq = wav.samp_freq
            raw = compute_pitch(wav.data[0], popts, device=device)
            w[utt] = postprocess_pitch(raw) if flags.post_process else raw
    return 0


def compute_spectrum_feats(argv) -> int:
    """Log power spectrogram features (reference:
    aslp-vadbin/aslp-compute-spectrum-feats.cc,
    aslp-vad/feature-spectrum.*)."""
    from kaldi_aslp_tpu_torch.feats.plp import Spectrogram
    from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
    from kaldi_aslp_tpu_torch.io import matrix_writer
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    tool = "aslp-compute-spectrum-feats"
    fo, dev_flags = FrameExtractionOptions(dither=0.0), DeviceFlags()
    args = parse_options(
        argv, [fo, dev_flags],
        f"{tool} [--device=cuda] scp:wav.scp ark:feats.ark", 2, 2)
    refuse_dither(tool, fo.dither)
    device = resolve_device(dev_flags.device)
    spec = None
    with matrix_writer(args[1]) as w:
        for utt, wav in iter_wavs(args[0]):
            if spec is None:
                fo.samp_freq = wav.samp_freq
                spec = Spectrogram(fo, device=device)
            w[utt] = spec(wav.data[0]).cpu().numpy()
    return 0


def apply_energy_vad(argv) -> int:
    from kaldi_aslp_tpu_torch.io import int_vector_writer
    from kaldi_aslp_tpu_torch.utils.device import resolve_device
    from kaldi_aslp_tpu_torch.vad import EnergyVad

    opts, dev_flags = VadOptions(), DeviceFlags()
    args = parse_options(
        argv, [opts, dev_flags],
        "aslp-apply-energy-vad [--device=cuda] scp:wav.scp ark:mask.ark",
        2, 2)
    vad = EnergyVad(opts, device=resolve_device(dev_flags.device))
    with int_vector_writer(args[1]) as w:
        for utt, wav in iter_wavs(args[0]):
            win = int(wav.samp_freq * opts.frame_length_ms / 1000)
            n = len(wav.data[0]) // win
            frames = wav.data[0][: n * win].reshape(n, win)
            w[utt] = vad.detect(frames).astype(np.int32)
    return 0


def apply_nnet_vad(argv) -> int:
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        sequential_matrix_reader,
    )
    from kaldi_aslp_tpu_torch.vad import NnetVad

    opts = VadOptions()
    args = parse_options(
        argv, [opts], "aslp-apply-nnet-vad post-rspec mask-wspec", 2, 2)
    vad = NnetVad(opts)
    with int_vector_writer(args[1]) as w:
        for utt, post in sequential_matrix_reader(args[0]):
            w[utt] = vad.detect_from_posteriors(
                np.asarray(post)).astype(np.int32)
    return 0


def ali_to_sil(argv) -> int:
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        sequential_int_vector_reader,
    )
    from kaldi_aslp_tpu_torch.vad import ali_to_sil_targets

    @dataclasses.dataclass
    class Flags(Config):
        sil_pdfs: str = "0"

    flags = Flags()
    args = parse_options(
        argv, [flags], "aslp-ali-to-sil ali-rspec targets-wspec", 2, 2)
    sil = [int(i) for i in flags.sil_pdfs.split(":")]
    with int_vector_writer(args[1]) as w:
        for utt, ali in sequential_int_vector_reader(args[0]):
            w[utt] = ali_to_sil_targets(ali, sil)
    return 0


def select_frames_cli(argv) -> int:
    from kaldi_aslp_tpu_torch.io import (
        matrix_writer,
        random_access_int_vector_reader,
        sequential_matrix_reader,
    )
    from kaldi_aslp_tpu_torch.vad import select_frames

    args = parse_options(
        argv, [],
        "aslp-select-frames feats-rspec mask-rspec feats-wspec", 3, 3)
    masks = random_access_int_vector_reader(args[1])
    with matrix_writer(args[2]) as w:
        for utt, feats in sequential_matrix_reader(args[0]):
            if utt not in masks:
                continue
            m = np.asarray(masks[utt])[: len(feats)]
            w[utt] = select_frames(feats[: len(m)], m)
    return 0


def _frame_counts(h: np.ndarray, r: np.ndarray):
    """(tp, fp, fn, tn) of boolean hypothesis ``h`` against ``r``."""
    return (int((h & r).sum()), int((h & ~r).sum()),
            int((~h & r).sum()), int((~h & ~r).sum()))


def _print_frame_scores(tp: int, fp: int, fn: int, tn: int) -> None:
    total = max(tp + fp + fn + tn, 1)
    print(f"frames {total} accuracy {(tp + tn) / total:.4f} "
          f"false_alarm {fp / max(fp + tn, 1):.4f} "
          f"miss {fn / max(fn + tp, 1):.4f}")


def _print_auc_eer(scores_all, labels_all) -> None:
    from kaldi_aslp_tpu_torch.vad.roc import auc, eer

    if scores_all:
        s = np.concatenate(scores_all)
        y = np.concatenate(labels_all)
        print(f"AUC {auc(s, y):.4f} EER {eer(s, y):.4f}")


def eval_vad_cli(argv) -> int:
    """Score VAD decisions against reference sil/speech targets: frame
    accuracy, false-alarm and miss rates, AUC and EER when scores are
    given (reference: aslp-vadbin/aslp-eval-energy-vad.cc,
    aslp-eval-nn-vad.cc, aslp_scripts/vad/calc_auc.sh / calc_eer.sh)."""
    from kaldi_aslp_tpu_torch.io import (
        sequential_int_vector_reader,
        sequential_matrix_reader,
    )

    args = parse_options(
        argv, [],
        "aslp-eval-vad hyp-mask-rspec ref-mask-rspec [scores-rspec]", 2, 3)
    refs = dict(sequential_int_vector_reader(args[1]))
    counts = np.zeros(4, np.int64)
    for utt, hyp in sequential_int_vector_reader(args[0]):
        ref = refs.get(utt)
        if ref is None:
            continue
        n = min(len(hyp), len(ref))
        counts += _frame_counts(np.asarray(hyp[:n]) > 0,
                                np.asarray(ref[:n]) > 0)
    _print_frame_scores(*(int(c) for c in counts))
    if len(args) > 2:
        scores_all, labels_all = [], []
        for utt, sc in sequential_matrix_reader(args[2]):
            ref = refs.get(utt)
            if ref is None:
                continue
            s = np.asarray(sc).reshape(-1)
            n = min(len(s), len(ref))
            scores_all.append(s[:n])
            labels_all.append(np.asarray(ref[:n]))
        _print_auc_eer(scores_all, labels_all)
    return 0


def apply_nnet_vad_segment(argv) -> int:
    """NN VAD -> speech segments, 'utt start_frame end_frame' lines
    (reference: aslp-vadbin/aslp-apply-nn-vad-segment.cc)."""
    from kaldi_aslp_tpu_torch.io import sequential_matrix_reader
    from kaldi_aslp_tpu_torch.vad import NnetVad

    opts = VadOptions()
    args = parse_options(
        argv, [opts],
        "aslp-apply-nn-vad-segment post-rspec segments-out.txt", 2, 2)
    vad = NnetVad(opts)
    with open(args[1], "w") as f:
        for utt, post in sequential_matrix_reader(args[0]):
            mask = vad.detect_from_posteriors(np.asarray(post))
            in_seg = False
            start = 0
            for t, m in enumerate(list(mask) + [0]):
                if m and not in_seg:
                    in_seg, start = True, t
                elif not m and in_seg:
                    in_seg = False
                    f.write(f"{utt} {start} {t}\n")
    return 0


@dataclasses.dataclass
class GlobalGmmOptions(Config):
    num_gauss: int = 32
    num_gauss_init: int = 0
    num_iters: int = 20
    num_frames: int = 200000
    min_gaussian_weight: float = 1e-4
    seed: int = 0


def gmm_global_init_from_feats(argv) -> int:
    """Train a global diagonal GMM from features (reference:
    src/gmmbin/gmm-global-init-from-feats.cc, driven by
    aslp_scripts/vad/train_diag_gmm.sh); the model is saved as .npz
    (``GlobalGmm.save``, JAX's file)."""
    from kaldi_aslp_tpu_torch.gmm.global_gmm import init_from_feats
    from kaldi_aslp_tpu_torch.io import sequential_matrix_reader
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    opts, dev_flags = GlobalGmmOptions(), DeviceFlags()
    args = parse_options(
        argv, [opts, dev_flags],
        "gmm-global-init-from-feats [--device=cuda] feats-rspec "
        "model-out.npz", 2, 2)
    device = resolve_device(dev_flags.device)
    frames = [f for _, f in sequential_matrix_reader(args[0])]
    feats = np.concatenate(frames, axis=0)
    gmm = init_from_feats(
        feats, opts.num_gauss, num_iters=opts.num_iters,
        num_gauss_init=opts.num_gauss_init, num_frames=opts.num_frames,
        min_gaussian_weight=opts.min_gaussian_weight, seed=opts.seed,
        device=device)
    gmm.save(args[1])
    return 0


@dataclasses.dataclass
class GmmVadCliOptions(Config):
    llr_threshold: float = 0.0


def _gmm_vad(argv, usage):
    """(GmmVad on --device, positional args) of a GMM VAD tool."""
    from kaldi_aslp_tpu_torch.gmm.global_gmm import GlobalGmm
    from kaldi_aslp_tpu_torch.utils.device import resolve_device
    from kaldi_aslp_tpu_torch.vad.gmm_vad import GmmVad

    vopts, gopts, dev_flags = VadOptions(), GmmVadCliOptions(), DeviceFlags()
    args = parse_options(argv, [vopts, gopts, dev_flags], usage, 4, 4)
    vad = GmmVad(GlobalGmm.load(args[0]), GlobalGmm.load(args[1]),
                 vopts, llr_threshold=gopts.llr_threshold,
                 device=resolve_device(dev_flags.device))
    return vad, args


def apply_gmm_vad(argv) -> int:
    """Classify frames by the speech / silence GMMs' log-likelihood ratio
    and smooth them with the FSM (reference: aslp_scripts/vad/
    run_gmm_vad.sh role)."""
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        sequential_matrix_reader,
    )

    vad, args = _gmm_vad(
        argv, "aslp-apply-gmm-vad [--device=cuda] sil.npz speech.npz "
        "feats-rspec mask-wspec")
    with int_vector_writer(args[3]) as w:
        for utt, feats in sequential_matrix_reader(args[2]):
            w[utt] = vad.detect(feats).astype(np.int32)
    return 0


def eval_vad_boundary_cli(argv) -> int:
    """Boundary placement accuracy of VAD decisions (reference:
    aslp-vadbin/aslp-eval-vad-boundary.cc, aslp-eval-nn-vad-boundary.cc
    through aslp-vad/boundary-tool.h)."""
    from kaldi_aslp_tpu_torch.io import (
        random_access_int_vector_reader,
        sequential_int_vector_reader,
    )
    from kaldi_aslp_tpu_torch.vad.boundary import BoundaryTool

    @dataclasses.dataclass
    class Flags(Config):
        context: int = 10

    flags = Flags()
    args = parse_options(
        argv, [flags], "aslp-eval-vad-boundary label-rspec hyp-rspec", 2, 2)
    tool = BoundaryTool(flags.context)
    hyps = random_access_int_vector_reader(args[1])
    num_done = num_err = 0
    for utt, label in sequential_int_vector_reader(args[0]):
        if utt not in hyps:
            num_err += 1
            continue
        hyp = np.asarray(hyps[utt])
        n = min(len(label), len(hyp))
        if tool.add_data(np.asarray(label[:n]), hyp[:n]):
            num_done += 1
        else:
            num_err += 1
    print(tool.report())
    print(f"Done {num_done} files; {num_err} with errors.")
    return 0 if num_done > 0 else 1


def eval_gmm_vad_cli(argv) -> int:
    """Apply the GMM-LLR VAD and score it against reference sil/speech
    targets in one pass (reference: aslp-vadbin/aslp-eval-gmm-vad.cc
    role)."""
    from kaldi_aslp_tpu_torch.io import (
        random_access_int_vector_reader,
        sequential_matrix_reader,
    )

    vad, args = _gmm_vad(
        argv, "aslp-eval-gmm-vad [--device=cuda] sil.npz speech.npz "
        "feats-rspec ref-rspec")
    refs = random_access_int_vector_reader(args[3])
    counts = np.zeros(4, np.int64)
    scores_all, labels_all = [], []
    for utt, feats in sequential_matrix_reader(args[2]):
        if utt not in refs:
            continue
        ref = np.asarray(refs[utt])
        scores = vad.frame_scores(feats)
        hyp = vad.smooth(scores > vad.llr_threshold)
        n = min(len(hyp), len(ref))
        counts += _frame_counts(hyp[:n] > 0, ref[:n] > 0)
        scores_all.append(scores[:n])
        labels_all.append(ref[:n])
    _print_frame_scores(*(int(c) for c in counts))
    _print_auc_eer(scores_all, labels_all)
    return 0
