"""FST and KWS CLI tools (reference: src/aslp-kwsbin/: aslp-fst-init,
aslp-fst-info, aslp-fst-to-dot, aslp-kws-score, aslp-kws-gen-state-map,
aslp-kws-convert-phone-ali; aslp_scripts/kws/evaluation_roc.py).

Port of kaldi_aslp_tpu/cli/fst_tools.py: the same arguments and the same
output text, on the port's fst/fst.py and kws/.  None of these tools
computes on tensors, so none takes ``--device``: ``aslp-kws-score``
reads posteriors from a table and runs the spotter's host DP.

``aslp-kws-gen-state-map`` reads pickles of the port's
``TransitionModel`` and tree (``cli/tree_tools.py``'s convention); a
JAX pickle names ``kaldi_aslp_tpu`` classes and is refused with a
message that says so.  The FST tools read integer labels, as JAX's do;
where JAX's fail on ``aslp-kws-gen-text-fst``'s symbol names with
``int()``'s bare error, the port's name the label and the fix (map the
text through a symbol table first)."""

from __future__ import annotations

import dataclasses
import pickle
import sys

import numpy as np

from kaldi_aslp_tpu_torch.fst.fst import Fst
from kaldi_aslp_tpu_torch.utils.config import Config, parse_options


def read_fst_text(path: str, tool: str) -> Fst:
    """An FST in the integer text format; a symbol name where a label
    belongs raises a ``ValueError`` that names it."""
    with open(path) as f:
        text = f.read()
    try:
        return Fst.from_text(text)
    except ValueError as err:
        for line in text.splitlines():
            for tok in line.split()[2:4]:
                if not tok.lstrip("-").isdigit():
                    raise ValueError(
                        f"{tool}: {path} holds the symbol {tok!r} where the "
                        "text format takes an integer label; map its labels "
                        "through a symbol table first") from err
        raise


class _PortOnlyUnpickler(pickle.Unpickler):
    """Loads the port's classes; refuses a pickle of the JAX package's."""

    def find_class(self, module, name):
        if module == "kaldi_aslp_tpu" or module.startswith("kaldi_aslp_tpu."):
            raise pickle.UnpicklingError(
                f"the pickle names {module}.{name}, a class of the JAX "
                "package (kaldi_aslp_tpu), which the port does not load; "
                "write the model with the port's tools "
                "(kaldi_aslp_tpu_torch)")
        return super().find_class(module, name)


def load_port_pickle(path: str):
    with open(path, "rb") as f:
        return _PortOnlyUnpickler(f).load()


def fst_init(argv):
    """Text topo -> the FST text format (reference: aslp-fst-init.cc)."""
    args = parse_options(argv, [], "aslp-fst-init topo.txt fst.txt", 2, 2)
    fst = read_fst_text(args[0], "aslp-fst-init")
    with open(args[1], "w") as f:
        f.write(fst.to_text())
    return 0


def fst_info(argv):
    args = parse_options(argv, [], "aslp-fst-info fst.txt", 1, 1)
    fst = read_fst_text(args[0], "aslp-fst-info")
    print(f"num-states {fst.num_states}")
    print(f"num-arcs {fst.num_arcs}")
    print(f"num-final {len(fst.finals)}")
    print(f"start {fst.start}")
    eps_arcs = sum(1 for s in range(fst.num_states)
                   for a in fst.arcs[s] if a.ilabel == 0)
    print(f"num-eps-input-arcs {eps_arcs}")
    return 0


def fst_to_dot(argv):
    args = parse_options(argv, [], "aslp-fst-to-dot fst.txt [dot]", 1, 2)
    fst = read_fst_text(args[0], "aslp-fst-to-dot")
    lines = ["digraph fst {", "rankdir=LR;"]
    for s in range(fst.num_states):
        shape = "doublecircle" if s in fst.finals else "circle"
        lines.append(f'  {s} [shape={shape}];')
        for a in fst.arcs[s]:
            lines.append(
                f'  {s} -> {a.nextstate} '
                f'[label="{a.ilabel}:{a.olabel}/{a.weight:g}"];'
            )
    lines.append("}")
    dot = "\n".join(lines)
    if len(args) > 1:
        with open(args[1], "w") as f:
            f.write(dot)
    else:
        print(dot)
    return 0


def kws_score(argv):
    """Posterior arks -> keyword hits (reference: aslp-kws-score.cc)."""
    from kaldi_aslp_tpu_torch.io import sequential_matrix_reader
    from kaldi_aslp_tpu_torch.kws import KeywordSpotter, KwsOptions

    @dataclasses.dataclass
    class Flags(Config):
        keywords: str = ""   # "name:1,2,3;other:4,5"
        confidence_threshold: float = 0.5

    flags = Flags()
    args = parse_options(
        argv, [flags], "aslp-kws-score --keywords=... post-rspec", 1, 1
    )
    keywords = {}
    for spec in flags.keywords.split(";"):
        if not spec:
            continue
        name, cols = spec.split(":")
        keywords[name] = [int(c) for c in cols.split(",")]
    spotter = KeywordSpotter(
        keywords,
        KwsOptions(confidence_threshold=flags.confidence_threshold),
    )
    for utt, post in sequential_matrix_reader(args[0]):
        for hit in spotter.spot(np.asarray(post)):
            print(f"{utt} {hit.keyword} {hit.confidence:.4f} "
                  f"{hit.start_frame} {hit.end_frame}")
    return 0


def kws_gen_state_map(argv):
    """Generate keyword state map files (reference:
    aslp-kws-gen-state-map.cc) from pickles of the port's transition
    model and tree."""
    from kaldi_aslp_tpu_torch.kws import gen_state_map, write_state_map

    @dataclasses.dataclass
    class Flags(Config):
        silence: str = "sil"

    flags = Flags()
    args = parse_options(
        argv, [flags],
        "aslp-kws-gen-state-map phones.txt keyword.lexicon mdl tree "
        "tid_map.txt state_list.txt", 6, 6,
    )
    phone_syms = {}
    with open(args[0]) as f:
        for line in f:
            toks = line.split()
            if len(toks) != 2 or toks[0].startswith(("<", "#")):
                continue
            phone_syms[toks[0]] = int(toks[1])
    lexicon = []
    with open(args[1]) as f:
        for line in f:
            if line.split():
                lexicon.append(line.split())
    trans_model = load_port_pickle(args[2])
    tree = load_port_pickle(args[3])
    sm = gen_state_map(phone_syms, lexicon, trans_model, tree,
                       silence=flags.silence)
    write_state_map(sm, args[4], args[5])
    return 0


def kws_convert_phone_ali(argv):
    """Map phone alignments through a phone map (reference:
    aslp-kws-convert-phone-ali.cc)."""
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        sequential_int_vector_reader,
    )
    from kaldi_aslp_tpu_torch.kws import convert_phone_ali, read_phone_map

    args = parse_options(
        argv, [],
        "aslp-kws-convert-phone-ali phone.map ark:old.ali ark:new.ali",
        3, 3,
    )
    phone_map = read_phone_map(args[0])
    n = 0
    with int_vector_writer(args[2]) as w:
        for utt, ali in sequential_int_vector_reader(args[1]):
            w[utt] = convert_phone_ali(phone_map, ali)
            n += 1
    print(f"Succeeded converting alignments for {n} files", file=sys.stderr)
    return 0 if n else 1


def kws_evaluation_roc(argv):
    """ROC threshold sweep over score/label files (reference:
    aslp_scripts/kws/evaluation_roc.py)."""
    from kaldi_aslp_tpu_torch.kws import roc_sweep

    @dataclasses.dataclass
    class Flags(Config):
        stride: float = 0.05

    flags = Flags()
    args = parse_options(
        argv, [flags], "aslp-kws-evaluation-roc score.txt label.txt", 2, 2
    )
    scores = {}
    with open(args[0]) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 2:
                continue
            vals = [float(x) for x in toks[1:] if x not in ("[", "]")]
            scores[toks[0]] = max(vals)
    labels = {}
    with open(args[1]) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                labels[toks[0]] = int(toks[1])
    for thresh, acc, fr, fa in roc_sweep(scores, labels, flags.stride):
        print(f"thresh {thresh:f} acc {acc:f} false_reject {fr:f} "
              f"false_alarm {fa:f}")
    return 0
