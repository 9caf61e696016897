"""Keyword state-map generation, phone-alignment conversion and the ROC
sweep of KWS training.

Port of kaldi_aslp_tpu/kws/state_map.py (reference:
src/aslp-kwsbin/aslp-kws-gen-state-map.cc, which maps the acoustic
model's pdfs onto a compact keyword-state inventory {0=<gbg> filler,
1=sil, 2..=CD keyword states} and writes a transition-id -> kws-state
table and a state symbol list; aslp-kws-convert-phone-ali.cc, which maps
alignments through a phone map; aslp_scripts/kws/evaluation_roc.py, a
threshold sweep over per-utterance scores and labels).  Host code on the
port's ``ContextDependency`` (tree/build_tree.py) and
``TransitionModel`` (hmm/transition_model.py).

Two rules are the JAX package's and the reference's, kept on purpose:
when two keyword CD states share a pdf the later one wins the pdf's
entry, and ``roc_sweep`` steps its threshold by accumulation
(``thresh += stride``), so its thresholds carry the sum's last bits
(0.15000000000000002 at stride 0.05), which ``roc.txt`` prints."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class KwsStateMap:
    """tid_map[tid] = kws state id (0 is also the filler/<gbg> state);
    state_list[i] = name of kws state i; keyword_states[word] = the CD
    state names along the keyword, in order (the KWS graph topology)."""
    tid_map: np.ndarray
    state_list: List[str]
    keyword_states: Dict[str, List[str]]


def gen_state_map(
    phone_syms: Mapping[str, int],
    keyword_lexicon: Sequence[Sequence[str]],
    trans_model,
    tree,
    silence: str = "sil",
) -> KwsStateMap:
    """Generate the keyword state mapping (reference:
    aslp-kws-gen-state-map.cc:117-236).

    ``keyword_lexicon`` rows are [word, phone, phone, ...] (>= 2 phones,
    mirroring the reference's assertion).  Keyword phones are looked up
    in triphone context along the pronunciation, with silence context at
    word edges; every (context, pdf_class) tree leaf becomes a keyword
    state.  Transition-ids whose pdf is not on any keyword map to the
    filler state 0; the silence phone's pdfs map to state 1."""
    if silence not in phone_syms:
        raise ValueError(f"silence phone {silence!r} not in phone table")
    n = tree.context_width
    p = tree.central_position
    if n != 3 or p != 1:
        raise ValueError("keyword state maps need a triphone tree (N=3 P=1)")
    sil_id = phone_syms[silence]

    pdf_mapping: Dict[int, int] = {}
    state_ids: Dict[str, int] = {"<gbg>": 0, silence: 1}
    # silence pdfs -> state 1 (reference :125-139)
    num_sil_classes = trans_model.topo.entry(sil_id).num_pdf_classes
    for pdf_class in range(num_sil_classes):
        pdf = tree.compute((0, sil_id, 0), pdf_class)
        pdf_mapping[pdf] = 1

    keyword_states: Dict[str, List[str]] = {}
    for row in keyword_lexicon:
        if len(row) < 3:
            raise ValueError(
                f"keyword {row!r}: need at least 2 phones (reference "
                "asserts lexicon[i].size() > 3 incl. the word)")
        word, phones = row[0], list(row[1:])
        states: List[str] = []
        for j, cur in enumerate(phones):
            if cur not in phone_syms:
                raise KeyError(f"phone {cur!r} not in phone table")
            prev = phones[j - 1] if j > 0 else silence
            nxt = phones[j + 1] if j + 1 < len(phones) else silence
            window = (phone_syms[prev], phone_syms[cur], phone_syms[nxt])
            context = f"{prev}_{cur}_{nxt}"
            classes = trans_model.topo.entry(phone_syms[cur]).num_pdf_classes
            for pdf_class in range(classes):
                cd_state = f"{context}_s{pdf_class}"
                pdf = tree.compute(window, pdf_class)
                if cd_state not in state_ids:
                    # a pdf shared with an earlier CD state now maps here:
                    # the later state wins, as in the reference
                    state_ids[cd_state] = len(state_ids)
                    pdf_mapping[pdf] = state_ids[cd_state]
                states.append(cd_state)
        keyword_states[word] = states

    tid_map = np.zeros(trans_model.num_transition_ids + 1, np.int32)
    for tid in range(1, trans_model.num_transition_ids + 1):
        tid_map[tid] = pdf_mapping.get(trans_model.tid_to_pdf(tid), 0)

    state_list = [""] * len(state_ids)
    for name, i in state_ids.items():
        state_list[i] = name
    return KwsStateMap(tid_map, state_list, keyword_states)


def write_state_map(sm: KwsStateMap, tid_map_path: str,
                    state_list_path: str) -> None:
    """Emit the two text files of the reference tool
    (aslp-kws-gen-state-map.cc:205-236): 'tid state' lines and a symbol
    table '<eps> 0' + 'state i+1' lines."""
    with open(tid_map_path, "w") as f:
        for tid in range(1, len(sm.tid_map)):
            f.write(f"{tid} {int(sm.tid_map[tid])}\n")
    with open(state_list_path, "w") as f:
        f.write("<eps> 0\n")
        for i, name in enumerate(sm.state_list):
            f.write(f"{name} {i + 1}\n")


def read_phone_map(path: str) -> np.ndarray:
    """'old new' integer pairs -> dense lookup (reference:
    aslp-kws-convert-phone-ali.cc KwsReadPhoneMap, with the same
    duplicate/range validation)."""
    pairs: List[Tuple[int, int]] = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            if len(toks) != 2:
                raise ValueError(f"bad phone-map line {line!r}")
            old, new = int(toks[0]), int(toks[1])
            if old <= 0 or new < 0:
                raise ValueError(f"bad phone-map entry {old} {new}")
            pairs.append((old, new))
    if not pairs:
        raise ValueError(f"empty phone map {path}")
    size = max(o for o, _ in pairs) + 1
    lut = np.full(size, -1, np.int32)
    for old, new in pairs:
        if lut[old] != -1:
            raise ValueError(f"duplicate phone-map entry for {old}")
        lut[old] = new
    return lut


def convert_phone_ali(phone_map: np.ndarray,
                      ali: np.ndarray) -> np.ndarray:
    """Map an alignment through the phone map (reference:
    aslp-kws-convert-phone-ali.cc main loop)."""
    ali = np.asarray(ali, np.int32)
    if ali.size and int(ali.max()) >= len(phone_map):
        raise ValueError("alignment symbol outside phone map")
    return phone_map[ali]


def roc_sweep(scores: Mapping[str, float], labels: Mapping[str, int],
              stride: float = 0.05) -> List[Tuple[float, float, float, float]]:
    """Threshold sweep -> (thresh, accuracy, false_reject_rate,
    false_alarm_rate) rows (reference:
    aslp_scripts/kws/evaluation_roc.py Roc/RocSet).  A positive is
    rejected below the threshold (``<``), a negative accepted above it
    (``>``): a score equal to the threshold counts as neither error."""
    keys = sorted(set(scores) & set(labels))
    if not keys:
        raise ValueError("no keys common to scores and labels")
    s = np.array([scores[k] for k in keys])
    y = np.array([labels[k] for k in keys])
    num_pos = int((y == 1).sum())
    num_neg = int((y != 1).sum())
    rows = []
    thresh = 0.0
    while thresh < 1.0:
        fr = int(((y == 1) & (s < thresh)).sum())
        fa = int(((y != 1) & (s > thresh)).sum())
        rows.append((
            thresh,
            1.0 - (fr + fa) / len(keys),
            fr / num_pos if num_pos else 0.0,
            fa / num_neg if num_neg else 0.0,
        ))
        thresh += stride
    return rows
