"""Decoding and alignment graphs: the H expansion of L o G and of C o L o G.

Port of kaldi_aslp_tpu/fst/hclg.py (``expand_hmm`` :24,
``make_decode_graph`` :65-82, ``expand_hmm_cd`` :85-128,
``triples_from_tree`` :130-146, ``TrainingGraphCompiler`` :148-168;
reference: utils/mkgraph.sh, make-h-transducer + add-self-loops,
src/decoder/training-graph-compiler.{h,cc}).

Monophone C is the identity, so HCLG = H(L o G): every phone arc of LG is
expanded in place into its topology's emitting-state chain, arcs labelled
with transition-ids (ilabel) and words (olabel), self-loops included.
Costs are -log probs.  In the context-dependent graphs (gmm/deltas.py)
the arcs of CLG carry context-window ids (fst/context.py) and each
emitting state's pdf comes from the decision tree."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from kaldi_aslp_tpu_torch.fst.determinize import (
    determinize,
    keep_raw_compose,
    minimize_encoded,
)
from kaldi_aslp_tpu_torch.fst.fst import EPS, Arc, Fst
from kaldi_aslp_tpu_torch.fst.lang import (
    Lang,
    make_lexicon_fst,
    make_linear_acceptor,
)
from kaldi_aslp_tpu_torch.hmm.transition_model import TransitionModel


def expand_hmm(lg: Fst, trans_model: TransitionModel) -> Fst:
    """Replace each phone-labelled arc of LG by its HMM state graph.

    Result ilabels are transition-ids (0 = eps); olabels pass through."""
    out = Fst()
    state_map = [out.add_state() for _ in range(lg.num_states)]
    out.set_start(state_map[lg.start])
    for s, w in lg.finals.items():
        out.set_final(state_map[s], w)

    for s in range(lg.num_states):
        for arc in lg.arcs[s]:
            if arc.ilabel == EPS:
                out.add_arc(state_map[s],
                            Arc(EPS, arc.olabel, arc.weight,
                                state_map[arc.nextstate]))
                continue
            phone = arc.ilabel
            n_emit = trans_model.topo.entry(phone).num_emitting
            internal = [out.add_state() for _ in range(n_emit)]
            after = state_map[arc.nextstate]
            # entry arc carries the word label + LM weight (eps input)
            out.add_arc(state_map[s],
                        Arc(EPS, arc.olabel, arc.weight, internal[0]))
            for i in range(n_emit):
                ts = trans_model.transition_state_of(phone, i)
                for ai, (dest, _p) in enumerate(trans_model.arcs_of(ts)):
                    tid = trans_model.pair_to_tid(ts, ai)
                    cost = -float(trans_model.log_probs[tid])
                    nxt = internal[dest] if dest < n_emit else after
                    out.add_arc(internal[i], Arc(tid, EPS, cost, nxt))
    return out.connect()


def make_decode_graph(lang: Lang, G: Fst, trans_model: TransitionModel,
                      sil_prob: float = 0.5,
                      optimize: bool = True) -> Fst:
    """HCLG (reference: utils/mkgraph.sh: fsttablecompose |
    fstdeterminizestar | fstminimizeencoded before the H expansion)."""
    L = make_lexicon_fst(lang, sil_prob=sil_prob).arc_sort("olabel")
    lg = L.compose(G)
    if optimize:
        with keep_raw_compose("the decode graph"):
            lg = minimize_encoded(determinize(lg.remove_epsilon()))
    return expand_hmm(lg, trans_model)


def expand_hmm_cd(clg: Fst, trans_model: TransitionModel, windows,
                  tree) -> Fst:
    """H expansion of a context-dependent CLG whose arcs carry context
    window ids (``windows``: the ``ContextWindows`` table of
    fst/context.py; ``tree``: a ``ContextDependency``); each emitting
    state's pdf is the tree's for the window (reference:
    make-h-transducer on the CLG side of mkgraph.sh)."""
    out = Fst()
    state_map = [out.add_state() for _ in range(clg.num_states)]
    out.set_start(state_map[clg.start])
    for s, w in clg.finals.items():
        out.set_final(state_map[s], w)
    central = tree.central_position
    for s in range(clg.num_states):
        for arc in clg.arcs[s]:
            if arc.ilabel == EPS:
                out.add_arc(state_map[s],
                            Arc(EPS, arc.olabel, arc.weight,
                                state_map[arc.nextstate]))
                continue
            window = windows.window(arc.ilabel)
            phone = window[central]
            entry = trans_model.topo.entry(phone)
            n_emit = entry.num_emitting
            internal = [out.add_state() for _ in range(n_emit)]
            after = state_map[arc.nextstate]
            out.add_arc(state_map[s],
                        Arc(EPS, arc.olabel, arc.weight, internal[0]))
            for i in range(n_emit):
                pdf = tree.compute(window, entry.states[i].pdf_class)
                ts = trans_model.transition_state(phone, i, pdf)
                for ai, (dest, _p) in enumerate(trans_model.arcs_of(ts)):
                    tid = trans_model.pair_to_tid(ts, ai)
                    cost = -float(trans_model.log_probs[tid])
                    nxt = internal[dest] if dest < n_emit else after
                    out.add_arc(internal[i], Arc(tid, EPS, cost, nxt))
    return out.connect()


def triples_from_tree(topo, tree, windows) -> List[Tuple[int, int, int]]:
    """The sorted (phone, hmm_state, pdf) triples the tree gives over the
    table's context windows (reference: transition-model.cc
    ComputeTriples via GetPdfInfo)."""
    triples = set()
    central = tree.central_position
    for window in windows.all_windows():
        phone = window[central]
        for hmm_state, st in enumerate(topo.entry(phone).states):
            if st.pdf_class < 0:
                continue
            triples.add(
                (phone, hmm_state, tree.compute(window, st.pdf_class)))
    return sorted(triples)


class TrainingGraphCompiler:
    """Per-utterance alignment graphs (reference:
    src/decoder/training-graph-compiler.h).

    Caches L; compiles a transcript to H(L o linear(words))."""

    def __init__(self, lang: Lang, trans_model: TransitionModel,
                 sil_prob: float = 0.5):
        self.lang = lang
        self.trans_model = trans_model
        self.L = make_lexicon_fst(lang, sil_prob=sil_prob
                                  ).arc_sort("olabel")
        self._cache: Dict[Tuple[int, ...], Fst] = {}

    def compile(self, words: Sequence[str]) -> Fst:
        wids = tuple(self.lang.words.id(w) for w in words)
        if wids not in self._cache:
            lg = self.L.compose(make_linear_acceptor(wids))
            self._cache[wids] = expand_hmm(lg, self.trans_model)
        return self._cache[wids]
