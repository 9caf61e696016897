"""CTC decoding graphs: a blank-loop token transducer over L o G.

The port's own copy of kaldi_aslp_tpu/fst/ctc_graph.py (reference:
src/aslp-bin/aslp-make-ctc-transducer.cc:36-120 MakeCtcLoopFst;
aslp_scripts/ctc/make_ctc_graph.sh:56-80).

Output-graph arc ilabels are "ctc-ids": ctc_id = output_index + 1, so 0
stays epsilon; output_index 0 is the blank.  A LUT maps ctc-ids to
posterior columns for the Viterbi decoder."""

from __future__ import annotations

import numpy as np

from kaldi_aslp_tpu_torch.fst.determinize import (
    determinize,
    keep_raw_compose,
    minimize_encoded,
)
from kaldi_aslp_tpu_torch.fst.fst import EPS, Arc, Fst
from kaldi_aslp_tpu_torch.fst.lang import Lang, make_lexicon_fst


def ctc_id_of_output(output_index: int) -> int:
    return output_index + 1


def ctc_lut(num_outputs: int) -> np.ndarray:
    """tid -> posterior-column LUT for the Viterbi decoder (index 0
    unused)."""
    lut = np.zeros(num_outputs + 1, np.int32)
    lut[1:] = np.arange(num_outputs)
    return lut


def expand_ctc(lg: Fst, phone_to_output) -> Fst:
    """Replace each phone arc of LG with the CTC token structure:

        junction --(blank*)--> [tok]+ --> next junction

    Every junction has a blank self-loop and each phone arc becomes a
    token state (self-loop = token repetition).  A token exit leading to
    a token of the SAME symbol must pass through at least one blank
    (reference: aslp-make-ctc-transducer.cc MakeCtcLoopFst), so the exit
    lands on a per-(junction, symbol) state whose entries skip that
    symbol, with a blank arc back to the full junction.

    phone_to_output: phone symbol id -> CTC output index (blank = 0)."""
    out = Fst()
    state_map = [out.add_state() for _ in range(lg.num_states)]
    out.set_start(state_map[lg.start])
    blank = ctc_id_of_output(0)
    for s, w in lg.finals.items():
        out.set_final(state_map[s], w)

    # first pass: token states and the entries of each junction
    entries = {s: [] for s in range(lg.num_states)}
    tok_state_of = {}   # (lg state, arc index) -> token state
    for s in range(lg.num_states):
        for k, arc in enumerate(lg.arcs[s]):
            if arc.ilabel == EPS:
                out.add_arc(state_map[s],
                            Arc(EPS, arc.olabel, arc.weight,
                                state_map[arc.nextstate]))
                continue
            tok = ctc_id_of_output(phone_to_output(arc.ilabel))
            tok_state = out.add_state()
            entries[s].append((tok, arc.olabel, arc.weight, tok_state))
            out.add_arc(tok_state, Arc(tok, EPS, 0.0, tok_state))
            tok_state_of[s, k] = tok_state

    post_states = {}  # (lg state, tok) -> restricted-entry state

    def get_post(s, tok_sym):
        key = (s, tok_sym)
        if key not in post_states:
            ps = out.add_state()
            post_states[key] = ps
            # blank returns to the full junction
            out.add_arc(ps, Arc(blank, EPS, 0.0, state_map[s]))
            for (tok, ol, w, ts) in entries[s]:
                if tok != tok_sym:
                    out.add_arc(ps, Arc(tok, ol, w, ts))
            # the junction's eps pass-through arcs still apply
            for arc in lg.arcs[s]:
                if arc.ilabel == EPS:
                    out.add_arc(ps, Arc(EPS, arc.olabel, arc.weight,
                                        state_map[arc.nextstate]))
            if s in lg.finals:
                out.set_final(ps, lg.finals[s])
        return post_states[key]

    # second pass: junction blank loops, token entries and exits
    for s in range(lg.num_states):
        out.add_arc(state_map[s], Arc(blank, EPS, 0.0, state_map[s]))
        for (tok, ol, w, ts) in entries[s]:
            out.add_arc(state_map[s], Arc(tok, ol, w, ts))
        for k, arc in enumerate(lg.arcs[s]):
            if arc.ilabel == EPS:
                continue
            tok = ctc_id_of_output(phone_to_output(arc.ilabel))
            out.add_arc(tok_state_of[s, k],
                        Arc(EPS, EPS, 0.0, get_post(arc.nextstate, tok)))
    return out.connect()


def make_ctc_decode_graph(lang: Lang, G: Fst,
                          phone_to_output=None,
                          sil_prob: float = 0.0) -> Fst:
    """TLG (reference: make_ctc_graph.sh): L o G, then the CTC token
    expansion.  The default phone -> output map is the ASLP convention
    (aslp-ali-minus-one): output_index = phone_id (phones are 1-based,
    the blank takes index 0)."""
    if phone_to_output is None:
        phone_to_output = lambda ph: ph   # noqa: E731
    L = make_lexicon_fst(lang, sil_prob=sil_prob if sil_prob > 0 else 1e-7
                         ).arc_sort("olabel")
    # det+min LG keeps the blank routing deterministic in the expanded
    # graph: each labeling then has one path, which sum-based lattice
    # and MBR posteriors need
    lg = L.compose(G).remove_epsilon()
    with keep_raw_compose("the TLG"):
        lg = minimize_encoded(determinize(lg))
    return expand_ctc(lg, phone_to_output)
