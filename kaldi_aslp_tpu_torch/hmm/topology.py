"""HMM topology (reference: src/hmm/hmm-topology.{h,cc}).

A copy of kaldi_aslp_tpu/hmm/topology.py (plain Python; the port imports
nothing of the JAX package).

Per-phone HMM prototypes: states with pdf-classes and transition lists.
Includes the Kaldi default Bakis topology (3 emitting states; 5 for
silence) used by prepare_lang.sh, and the "fake" degenerate topologies
the ASLP CD-phone / CTC pipelines write (reference:
aslp_scripts/cd_phone/make_fake_topo.sh:22-41 — 2-state self-loop topo;
aslp_scripts/ctc/prepare_mono_phone_ctc.sh:28-40 — 1-state)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


@dataclass
class HmmState:
    pdf_class: int  # -1 for non-emitting final state
    transitions: List[Tuple[int, float]] = field(default_factory=list)
    # list of (destination state, initial probability)


@dataclass
class TopologyEntry:
    states: List[HmmState]

    @property
    def num_emitting(self) -> int:
        return sum(1 for s in self.states if s.pdf_class >= 0)

    @property
    def num_pdf_classes(self) -> int:
        return 1 + max((s.pdf_class for s in self.states
                        if s.pdf_class >= 0), default=-1)


class HmmTopology:
    def __init__(self):
        self.entries: Dict[int, TopologyEntry] = {}  # phone → entry

    @property
    def phones(self) -> List[int]:
        return sorted(self.entries)

    def entry(self, phone: int) -> TopologyEntry:
        return self.entries[phone]

    @classmethod
    def default(
        cls,
        phones: Sequence[int],
        sil_phones: Sequence[int] = (),
        num_states: int = 3,
        num_sil_states: int = 5,
    ) -> "HmmTopology":
        """Kaldi's standard Bakis topology (utils/gen_topo.pl semantics)."""
        topo = cls()
        sil_set = set(sil_phones)
        for ph in phones:
            n = num_sil_states if ph in sil_set else num_states
            states = []
            if ph in sil_set and n > 3:
                # silence: richer transitions (each state may jump ahead),
                # following Kaldi's prepare_lang 5-state silence entry
                mid = list(range(1, n - 1))
                for i in range(n):
                    if i == 0:
                        dests = [0] + mid[:1] + ([mid[1]] if len(mid) > 1
                                                 else [])
                    elif i < n - 1:
                        dests = mid + [n - 1] if i == n - 2 else [i] + \
                            [d for d in mid + [n - 1] if d > i]
                        dests = sorted(set([i] + dests))
                    else:
                        dests = []
                    p = 1.0 / len(dests) if dests else 0.0
                    states.append(HmmState(
                        pdf_class=i if i < n - 1 else -1,
                        transitions=[(d, p) for d in dests],
                    ))
                # final state has no transitions (non-emitting)
                states[-1] = HmmState(pdf_class=-1, transitions=[])
            else:
                for i in range(n):
                    states.append(HmmState(
                        pdf_class=i,
                        transitions=[(i, 0.5), (i + 1, 0.5)],
                    ))
                states.append(HmmState(pdf_class=-1, transitions=[]))
            topo.entries[ph] = TopologyEntry(states)
        return topo

    @classmethod
    def fake_ctc(cls, phones: Sequence[int]) -> "HmmTopology":
        """1-state self-loop topology for CTC label prep (reference:
        aslp_scripts/ctc/prepare_mono_phone_ctc.sh)."""
        topo = cls()
        for ph in phones:
            topo.entries[ph] = TopologyEntry([
                HmmState(0, [(0, 0.5), (1, 0.5)]),
                HmmState(-1, []),
            ])
        return topo

    @classmethod
    def fake_min_duration(cls, phones: Sequence[int],
                          min_frames: int = 3,
                          self_jump: float = 0.5) -> "HmmTopology":
        """Single-pdf topo whose unit must persist >= ``min_frames``
        frames: a chain of emitting states all sharing pdf-class 0,
        only the last of which self-loops (reference:
        src/aslp-bin/aslp-make-h3-transducer.cc GetHmmAsFst3 — "one hmm
        state continues at least 3 frames" — driven by
        aslp_scripts/cd_phone/make_h3_graph.sh)."""
        topo = cls()
        for ph in phones:
            states = [HmmState(0, [(i + 1, 1.0)])
                      for i in range(min_frames - 1)]
            states.append(HmmState(0, [(min_frames - 1, self_jump),
                                       (min_frames, 1.0 - self_jump)]))
            states.append(HmmState(-1, []))
            topo.entries[ph] = TopologyEntry(states)
        return topo

    @classmethod
    def fake_cd_phone(cls, phones: Sequence[int],
                      num_states: int = 2) -> "HmmTopology":
        """N-state self-loop topo for CD-phone targets (reference:
        aslp_scripts/cd_phone/make_fake_topo.sh:22-41)."""
        topo = cls()
        for ph in phones:
            states = [HmmState(i, [(i, 0.5), (i + 1, 0.5)])
                      for i in range(num_states)]
            states.append(HmmState(-1, []))
            topo.entries[ph] = TopologyEntry(states)
        return topo
