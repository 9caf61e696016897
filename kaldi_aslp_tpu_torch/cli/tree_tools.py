"""Tree / CD-phone / graph-prep CLI tools.

Port of kaldi_aslp_tpu/cli/tree_tools.py: the reference CD-phone binary
family
(reference: src/aslp-bin/aslp-acc-tree-stats-cd-phone-{equal,kmeans,
viterbi}.cc, aslp-acc-tree-stats-phone-{mean,mean-per-frame,median}.cc,
aslp-compile-questions-phone.cc, aslp-tree-bind-info.cc,
aslp-cluster-kmeans-cd-phone-test.cc, aslp-convert-ali.cc,
aslp-make-ctc-transducer.cc, aslp-make-h3-transducer.cc).

Framework model files (transition models, trees, stats) are pickles,
the JAX package's CLI convention.  The port's tools pickle and load the
port's own classes (``kaldi_aslp_tpu_torch.hmm``, ``.tree``): a JAX
pickle names ``kaldi_aslp_tpu`` classes, which the port cannot load
without importing the JAX package, so files cross between the packages
as their outputs (stats, questions, alignments, FSTs), not as pickles.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config, parse_options
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("tree-cli")


@dataclasses.dataclass
class TreeStatsFlags(Config):
    method: str = ""            # set from the tool name when empty
    context_width: int = 3
    central_position: int = 1
    ci_phones: str = ""         # colon-separated, e.g. "1:2:3"


def _parse_ci(spec: str):
    return [int(p) for p in spec.split(":") if p] if spec else []


def acc_tree_stats_cd_phone_cli(argv, method: str = ""):
    """Accumulate per-phone-segment Gaussian stats keyed by the phone
    window (reference: aslp-acc-tree-stats-cd-phone-kmeans.cc main;
    variants select the segment summarizer)."""
    flags = TreeStatsFlags(method=method)
    args = parse_options(
        argv, [flags],
        "aslp-acc-tree-stats-cd-phone-* [--method=kmeans|equal|viterbi|"
        "mean|mean-per-frame|median] trans-model feats-rspec ali-rspec "
        "stats-out",
        4, 4,
    )
    from kaldi_aslp_tpu_torch.io import (
        random_access_int_vector_reader,
        sequential_matrix_reader,
    )
    from kaldi_aslp_tpu_torch.tree.cd_phone import acc_tree_stats_cd_phone

    with open(args[0], "rb") as f:
        tm = pickle.load(f)
    alis = random_access_int_vector_reader(args[2])
    stats = {}
    num_done = num_err = 0
    for utt, feats in sequential_matrix_reader(args[1]):
        if utt not in alis:
            logger.warning("no alignment for %s", utt)
            num_err += 1
            continue
        ali = np.asarray(alis[utt])
        if len(ali) != len(feats):
            logger.warning("length mismatch for %s (%d vs %d)", utt,
                           len(ali), len(feats))
            num_err += 1
            continue
        acc_tree_stats_cd_phone(
            np.asarray(feats), ali, tm,
            method=flags.method or "kmeans",
            context_width=flags.context_width,
            central_position=flags.central_position,
            ci_phones=_parse_ci(flags.ci_phones),
            stats=stats,
        )
        num_done += 1
    with open(args[3], "wb") as f:
        pickle.dump(stats, f)
    logger.info("accumulated stats for %d contexts from %d utts "
                "(%d errors)", len(stats), num_done, num_err)
    return 0 if num_done > 0 else 1


def _make_stats_tool(method):
    def tool(argv):
        return acc_tree_stats_cd_phone_cli(argv, method=method)
    tool.__doc__ = (
        f"acc-tree-stats variant with the {method!r} segment summarizer "
        f"(reference: src/aslp-bin/)."
    )
    return tool


acc_tree_stats_cd_phone_equal = _make_stats_tool("equal")
acc_tree_stats_cd_phone_kmeans = _make_stats_tool("kmeans")
acc_tree_stats_cd_phone_viterbi = _make_stats_tool("viterbi")
acc_tree_stats_phone_mean = _make_stats_tool("mean")
acc_tree_stats_phone_mean_per_frame = _make_stats_tool("mean-per-frame")
acc_tree_stats_phone_median = _make_stats_tool("median")


def compile_questions_phone_cli(argv):
    """Cluster phones by their CD-phone stats into question sets
    (reference: aslp-compile-questions-phone.cc)."""
    args = parse_options(
        argv, [],
        "aslp-compile-questions-phone stats-in questions-out",
        2, 2,
    )
    from kaldi_aslp_tpu_torch.tree.cd_phone import compile_questions_phone

    with open(args[0], "rb") as f:
        stats = pickle.load(f)
    phones = sorted({window[len(window) // 2] for window, _ in stats})
    questions = compile_questions_phone(stats, phones)
    with open(args[1], "w") as f:
        for q in questions:
            f.write(" ".join(str(p) for p in q) + "\n")
    logger.info("wrote %d questions over %d phones", len(questions),
                len(phones))
    return 0


def tree_bind_info_cli(argv):
    """Dump 'l c r -> cd-phone id' for every seen context (reference:
    aslp-tree-bind-info.cc)."""
    args = parse_options(
        argv, [], "aslp-tree-bind-info tree stats-in [txt-out]", 2, 3
    )
    from kaldi_aslp_tpu_torch.tree.cd_phone import tree_bind_info

    with open(args[0], "rb") as f:
        tree = pickle.load(f)
    with open(args[1], "rb") as f:
        stats = pickle.load(f)
    text = tree_bind_info(tree, stats)
    if len(args) > 2:
        with open(args[2], "w") as f:
            f.write(text)
    else:
        print(text, end="")
    return 0


def cluster_kmeans_cd_phone_test_cli(argv):
    """Self-check of the segment k-means (reference:
    aslp-cluster-kmeans-cd-phone-test.cc is an in-binary test): cluster
    synthetic 3-mode segments and assert the recovered means separate."""
    parse_options(argv, [], "aslp-cluster-kmeans-cd-phone-test", 0, 0)
    from kaldi_aslp_tpu_torch.tree.cd_phone import NUM_SUBSTATES, \
        summarize_kmeans

    rng = np.random.RandomState(0)
    dim = 8
    centers = rng.randn(NUM_SUBSTATES, dim) * 4.0
    frames = np.concatenate([
        centers[k] + 0.1 * rng.randn(20, dim)
        for k in range(NUM_SUBSTATES)
    ])
    vec = summarize_kmeans(frames)
    got = vec.reshape(NUM_SUBSTATES, dim)
    err = np.abs(np.sort(got[:, 0]) - np.sort(centers[:, 0])).max()
    assert err < 0.5, f"kmeans failed to recover centers (err {err})"
    print("aslp-cluster-kmeans-cd-phone-test: OK")
    return 0


def convert_ali_cli(argv):
    """Convert alignments from one (model, tree) pair to another
    (reference: aslp-convert-ali.cc / src/bin/convert-ali.cc role)."""
    @dataclasses.dataclass
    class Flags(Config):
        context_width: int = 3
        central_position: int = 1

    flags = Flags()
    args = parse_options(
        argv, [flags],
        "aslp-convert-ali old-model new-model new-tree ali-rspec "
        "ali-wspec   (new-tree may be '-' for a monophone new system)",
        5, 5,
    )
    from kaldi_aslp_tpu_torch.hmm.convert_ali import convert_alignment
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        sequential_int_vector_reader,
    )

    with open(args[0], "rb") as f:
        old_tm = pickle.load(f)
    with open(args[1], "rb") as f:
        new_tm = pickle.load(f)
    tree = None
    if args[2] != "-":
        with open(args[2], "rb") as f:
            tree = pickle.load(f)
    num_done = num_err = 0
    with int_vector_writer(args[4]) as writer:
        for utt, ali in sequential_int_vector_reader(args[3]):
            try:
                new_ali = convert_alignment(
                    np.asarray(ali), old_tm, new_tm, tree=tree,
                    context_width=flags.context_width,
                    central_position=flags.central_position,
                )
            except (KeyError, ValueError, IndexError) as e:
                logger.warning("could not convert %s: %s", utt, e)
                num_err += 1
                continue
            writer.write(utt, new_ali)
            num_done += 1
    logger.info("converted %d alignments (%d errors)", num_done, num_err)
    return 0 if num_done > 0 else 1


def make_ctc_transducer_cli(argv):
    """Expand a det/min LG into the CTC decode graph: token arcs with a
    blank self-loop state and mandatory blank between repeated tokens
    (reference: aslp-make-ctc-transducer.cc MakeCtcLoopFst:36-120; our
    fst/ctc_graph.py expand_ctc)."""
    args = parse_options(
        argv, [],
        "aslp-make-ctc-transducer phone-map.txt lg-fst.txt out-fst.txt\n"
        "phone-map.txt lines: <phone-ilabel> <ctc-output-index>",
        3, 3,
    )
    from kaldi_aslp_tpu_torch.fst.ctc_graph import expand_ctc
    from kaldi_aslp_tpu_torch.fst.fst import Fst

    phone_to_output = {}
    with open(args[0]) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                phone_to_output[int(parts[0])] = int(parts[1])
    with open(args[1]) as f:
        lg = Fst.from_text(f.read())
    out = expand_ctc(lg, phone_to_output.__getitem__)
    with open(args[2], "w") as f:
        f.write(out.to_text())
    logger.info("CTC transducer: %d states %d arcs", out.num_states,
                out.num_arcs)
    return 0


def make_h3_transducer_cli(argv):
    """Expand LG (or CLG) arcs into per-phone HMM chains with
    transition-id input labels and self-loops (reference:
    aslp-make-h3-transducer.cc GetHmmAsFst3; our fst/hclg.py
    expand_hmm)."""
    args = parse_options(
        argv, [],
        "aslp-make-h3-transducer trans-model lg-fst.txt out-fst.txt",
        3, 3,
    )
    from kaldi_aslp_tpu_torch.fst.fst import Fst
    from kaldi_aslp_tpu_torch.fst.hclg import expand_hmm

    with open(args[0], "rb") as f:
        tm = pickle.load(f)
    with open(args[1]) as f:
        lg = Fst.from_text(f.read())
    out = expand_hmm(lg, tm)
    with open(args[2], "w") as f:
        f.write(out.to_text())
    logger.info("H-expanded graph: %d states %d arcs", out.num_states,
                out.num_arcs)
    return 0
