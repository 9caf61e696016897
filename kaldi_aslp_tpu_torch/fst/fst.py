"""Weighted FSTs (tropical semiring) for graph construction.

The port's own copy of kaldi_aslp_tpu/fst/fst.py (``EPS``, ``Arc``,
``Fst`` with its rational operations, ``SymbolTable``; reference:
src/fstext/ fsttablecompose, src/aslp-kws/fst.{h,cc}), with the names
and layouts kept, so that the port never imports the JAX package.
Host-side construction only: the decoder runs over the packed arc
arrays of ``to_arrays``.  Weights are
costs (-log probs) and label 0 is epsilon, as in OpenFst, so text dumps
interoperate with the reference tooling.

``compose`` is the JAX package's Python path (``_compose_py``); that
package's native C++ helper gives identical output
(kaldi_aslp_tpu/fst/fst.py:248-260) and is neither built nor loaded
here."""

from __future__ import annotations

import heapq
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

EPS = 0
INF = float("inf")


@dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int


class Fst:
    def __init__(self):
        self.arcs: List[List[Arc]] = []
        self.finals: Dict[int, float] = {}
        self.start: int = -1
        self._label_index: Dict[int, Dict[int, List[Arc]]] = {}

    # -- construction -------------------------------------------------------
    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def add_arc(self, state: int, arc: Arc) -> None:
        self.arcs[state].append(arc)
        self._label_index.pop(state, None)

    def arcs_with_label(self, state: int, label: int):
        """Arcs of ``state`` whose ilabel == label, from a per-state
        index built at first use (dropped by add_arc): a backoff LM's
        unigram state holds about a vocabulary of arcs, so a scan per
        consumed word would make lattice rescoring O(V) an arc."""
        d = self._label_index.get(state)
        if d is None:
            d = {}
            for a in self.arcs[state]:
                d.setdefault(a.ilabel, []).append(a)
            self._label_index[state] = d
        return d.get(label, ())

    def set_start(self, s: int) -> None:
        self.start = s

    def set_final(self, s: int, weight: float = 0.0) -> None:
        self.finals[s] = weight

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def is_final(self, s: int) -> bool:
        return s in self.finals

    # -- basic algorithms ---------------------------------------------------
    def connect(self) -> "Fst":
        """Trim inaccessible / non-coaccessible states (OpenFst
        Connect)."""
        if self.start < 0:
            return Fst()
        fwd = set()
        stack = [self.start]
        while stack:
            s = stack.pop()
            if s in fwd:
                continue
            fwd.add(s)
            for a in self.arcs[s]:
                if a.nextstate not in fwd:
                    stack.append(a.nextstate)
        preds: Dict[int, List[int]] = defaultdict(list)
        for s in fwd:
            for a in self.arcs[s]:
                preds[a.nextstate].append(s)
        bwd = set()
        stack = [f for f in self.finals if f in fwd]
        while stack:
            s = stack.pop()
            if s in bwd:
                continue
            bwd.add(s)
            stack.extend(p for p in preds[s] if p not in bwd)
        keep = fwd & bwd
        remap = {}
        out = Fst()
        for s in sorted(keep):
            remap[s] = out.add_state()
        if self.start in remap:
            out.set_start(remap[self.start])
        for s in keep:
            for a in self.arcs[s]:
                if a.nextstate in keep:
                    out.add_arc(remap[s], Arc(a.ilabel, a.olabel,
                                              a.weight, remap[a.nextstate]))
            if s in self.finals:
                out.set_final(remap[s], self.finals[s])
        return out

    def arc_sort(self, by: str = "ilabel") -> "Fst":
        key = ((lambda a: a.ilabel) if by == "ilabel"
               else (lambda a: a.olabel))
        for lst in self.arcs:
            lst.sort(key=key)
        return self

    def remove_epsilon(self) -> "Fst":
        """Remove arcs with ilabel == olabel == eps by epsilon closure
        (right for the acyclic-epsilon graphs built here)."""
        def closure(s: int) -> Dict[int, float]:
            best: Dict[int, float] = {s: 0.0}
            heap = [(0.0, s)]
            while heap:
                w, u = heapq.heappop(heap)
                if w > best.get(u, INF):
                    continue
                for a in self.arcs[u]:
                    if a.ilabel == EPS and a.olabel == EPS:
                        nw = w + a.weight
                        if nw < best.get(a.nextstate, INF):
                            best[a.nextstate] = nw
                            heapq.heappush(heap, (nw, a.nextstate))
            return best

        out = Fst()
        for _ in range(self.num_states):
            out.add_state()
        out.set_start(self.start)
        for s in range(self.num_states):
            cl = closure(s)
            for u, w in cl.items():
                for a in self.arcs[u]:
                    if a.ilabel == EPS and a.olabel == EPS:
                        continue
                    out.add_arc(s, Arc(a.ilabel, a.olabel, a.weight + w,
                                       a.nextstate))
                if u in self.finals:
                    fw = w + self.finals[u]
                    if fw < out.finals.get(s, INF):
                        out.set_final(s, fw)
        return out.connect()

    # -- rational operations ------------------------------------------------
    @classmethod
    def linear(cls, labels: Iterable[Tuple[int, int]],
               weights: Optional[List[float]] = None) -> "Fst":
        """Linear chain from (ilabel, olabel) pairs."""
        f = cls()
        cur = f.add_state()
        f.set_start(cur)
        for i, (il, ol) in enumerate(labels):
            nxt = f.add_state()
            f.add_arc(cur, Arc(il, ol, weights[i] if weights else 0.0, nxt))
            cur = nxt
        f.set_final(cur)
        return f

    def _copy_into(self, out: "Fst", off: int) -> None:
        """Every arc of ``self`` into ``out``, states shifted by ``off``."""
        for s in range(self.num_states):
            for a in self.arcs[s]:
                out.add_arc(off + s, Arc(a.ilabel, a.olabel, a.weight,
                                         off + a.nextstate))

    def concat(self, other: "Fst") -> "Fst":
        """``self`` then ``other``: each final state of ``self`` takes an
        epsilon arc, weighted by its final weight, to ``other``'s start."""
        out = Fst()
        off = self.num_states
        for _ in range(self.num_states + other.num_states):
            out.add_state()
        out.set_start(self.start)
        self._copy_into(out, 0)
        for s, w in self.finals.items():
            out.add_arc(s, Arc(EPS, EPS, w, off + other.start))
        other._copy_into(out, off)
        for s, w in other.finals.items():
            out.set_final(off + s, w)
        return out

    def union(self, other: "Fst") -> "Fst":
        """A new start state with epsilon arcs into both machines."""
        out = Fst()
        out.set_start(out.add_state())
        for _ in range(self.num_states + other.num_states):
            out.add_state()
        off1, off2 = 1, 1 + self.num_states
        out.add_arc(out.start, Arc(EPS, EPS, 0.0, off1 + self.start))
        out.add_arc(out.start, Arc(EPS, EPS, 0.0, off2 + other.start))
        self._copy_into(out, off1)
        other._copy_into(out, off2)
        for s, w in self.finals.items():
            out.set_final(off1 + s, w)
        for s, w in other.finals.items():
            out.set_final(off2 + s, w)
        return out

    def closure(self) -> "Fst":
        """Kleene star: each final state loops back to the start by an
        epsilon arc of its final weight, and the start is final."""
        out = Fst()
        for _ in range(self.num_states):
            out.add_state()
        out.set_start(self.start)
        self._copy_into(out, 0)
        for s, w in self.finals.items():
            out.set_final(s, w)
            out.add_arc(s, Arc(EPS, EPS, w, self.start))
        out.set_final(self.start, 0.0)
        return out

    # -- composition --------------------------------------------------------
    def compose(self, other: "Fst") -> "Fst":
        """Tropical composition with the standard epsilon-sequencing
        filter (reference: fstext/table-matcher.h, fsttablecompose)."""
        out = Fst()
        state_map: Dict[Tuple[int, int, int], int] = {}

        def get(s1, s2, f):
            key = (s1, s2, f)
            if key not in state_map:
                state_map[key] = out.add_state()
            return state_map[key]

        start = get(self.start, other.start, 0)
        out.set_start(start)
        queue = deque([(self.start, other.start, 0)])
        seen = {(self.start, other.start, 0)}
        while queue:
            s1, s2, f = queue.popleft()
            cur = get(s1, s2, f)
            if s1 in self.finals and s2 in other.finals:
                out.set_final(cur, self.finals[s1] + other.finals[s2])

            def push(n1, n2, nf, il, ol, w):
                if (n1, n2, nf) not in seen:
                    seen.add((n1, n2, nf))
                    queue.append((n1, n2, nf))
                out.add_arc(cur, Arc(il, ol, w, get(n1, n2, nf)))

            arcs2_by_il: Dict[int, List[Arc]] = defaultdict(list)
            for a2 in other.arcs[s2]:
                arcs2_by_il[a2.ilabel].append(a2)
            for a1 in self.arcs[s1]:
                if a1.olabel != EPS:
                    for a2 in arcs2_by_il.get(a1.olabel, ()):
                        push(a1.nextstate, a2.nextstate, 0,
                             a1.ilabel, a2.olabel, a1.weight + a2.weight)
                elif f != 2:
                    # eps-output move on the left machine
                    push(a1.nextstate, s2, 1, a1.ilabel, EPS, a1.weight)
            if f != 1:
                for a2 in arcs2_by_il.get(EPS, ()):
                    # eps-input move on the right machine
                    push(s1, a2.nextstate, 2, EPS, a2.olabel, a2.weight)
        return out.connect()

    # -- text I/O (OpenFst format) ------------------------------------------
    def to_text(self) -> str:
        if self.start < 0 or self.num_states == 0:
            return "\n"
        lines = []
        order = [self.start] + [s for s in range(self.num_states)
                                if s != self.start]
        for s in order:
            for a in self.arcs[s]:
                lines.append(
                    f"{s}\t{a.nextstate}\t{a.ilabel}\t{a.olabel}"
                    f"\t{a.weight:g}"
                )
            if s in self.finals:
                w = self.finals[s]
                lines.append(f"{s}\t{w:g}" if w else f"{s}")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_text(cls, text: str) -> "Fst":
        f = cls()

        def ensure(s):
            while f.num_states <= s:
                f.add_state()
            return s
        first = True
        for line in text.strip().splitlines():
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 4:
                s, d = ensure(int(parts[0])), ensure(int(parts[1]))
                w = float(parts[4]) if len(parts) > 4 else 0.0
                f.add_arc(s, Arc(int(parts[2]), int(parts[3]), w, d))
            else:
                s = ensure(int(parts[0]))
                f.set_final(s, float(parts[1]) if len(parts) > 1 else 0.0)
            if first:
                f.set_start(s)
                first = False
        return f

    # -- packing for the decoder --------------------------------------------
    def to_arrays(self):
        """CSR-style arc arrays (src, dst, ilabel, olabel, weight) and
        final costs: the layout the dense Viterbi consumes."""
        src, dst, il, ol, w = [], [], [], [], []
        for s in range(self.num_states):
            for a in self.arcs[s]:
                src.append(s)
                dst.append(a.nextstate)
                il.append(a.ilabel)
                ol.append(a.olabel)
                w.append(a.weight)
        final = np.full(self.num_states, INF, np.float32)
        for s, fw in self.finals.items():
            final[s] = fw
        return {
            "src": np.asarray(src, np.int32),
            "dst": np.asarray(dst, np.int32),
            "ilabel": np.asarray(il, np.int32),
            "olabel": np.asarray(ol, np.int32),
            "weight": np.asarray(w, np.float32),
            "final": final,
            "start": self.start,
            "num_states": self.num_states,
        }


class SymbolTable:
    """(reference: aslp-kws/fst.h SymbolTable; OpenFst symbol tables)."""

    def __init__(self):
        self._sym2id: Dict[str, int] = {"<eps>": 0}
        self._id2sym: Dict[int, str] = {0: "<eps>"}

    def add(self, sym: str) -> int:
        if sym not in self._sym2id:
            i = len(self._sym2id)
            self._sym2id[sym] = i
            self._id2sym[i] = sym
        return self._sym2id[sym]

    def id(self, sym: str) -> int:
        return self._sym2id[sym]

    def sym(self, i: int) -> str:
        return self._id2sym[i]

    def __contains__(self, sym: str) -> bool:
        return sym in self._sym2id

    def __len__(self) -> int:
        return len(self._sym2id)

    def to_text(self) -> str:
        return "\n".join(f"{s} {i}" for s, i in
                         sorted(self._sym2id.items(), key=lambda kv: kv[1]))

    @classmethod
    def from_text(cls, text: str) -> "SymbolTable":
        t = cls()
        for line in text.strip().splitlines():
            sym, i = line.split()
            t._sym2id[sym] = int(i)
            t._id2sym[int(i)] = sym
        return t
