"""N-best extraction from lattices and LM rescoring of the list.

Copy of the numpy module kaldi_aslp_tpu/decoder/nbest.py (reference:
src/latbin/lattice-to-nbest.cc, lattice-lmrescore.cc) over the port's
own ``fst.Fst``.  The lattice is a DAG over (frame, state) nodes, so the
exact n-best is one topological DP keeping the n best entries with
distinct word sequences a node; rescoring swaps each hypothesis' LM
cost for a G acceptor's."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_aslp_tpu_torch.decoder.lattice import Lattice, LatticeArc
from kaldi_aslp_tpu_torch.fst.fst import EPS, Fst


@dataclass
class NBestEntry:
    words: Tuple[int, ...]
    total_cost: float       # at extraction scales
    graph_cost: float
    acoustic_cost: float


def lattice_nbest(
    lat: Lattice,
    n: int = 10,
    acoustic_scale: float = 1.0,
    lm_scale: float = 1.0,
) -> List[NBestEntry]:
    """Exact n-best distinct-path extraction (k-shortest in the DAG)."""
    arcs_by_t: Dict[int, List[LatticeArc]] = defaultdict(list)
    for a in lat.arcs:
        arcs_by_t[a.t].append(a)
    # per node: list of (cost, graph_cost, acoustic_cost, words)
    Entry = Tuple[float, float, float, Tuple[int, ...]]
    best: Dict[Tuple[int, int], List[Entry]] = {
        (0, lat.start): [(0.0, 0.0, 0.0, ())]
    }
    for t in range(1, lat.num_frames + 1):
        new_entries: Dict[Tuple[int, int], List[Entry]] = defaultdict(list)
        for a in arcs_by_t.get(t, ()):  # arcs consuming frame t-1
            src = best.get((t - 1, a.src))
            if not src:
                continue
            for (c, g, ac, w) in src:
                new_entries[(t, a.dst)].append((
                    c + lm_scale * a.graph_cost
                    + acoustic_scale * a.acoustic_cost,
                    g + a.graph_cost, ac + a.acoustic_cost,
                    w + a.words,
                ))
        for key, entries in new_entries.items():
            # keep n best with DISTINCT word sequences per node
            entries.sort(key=lambda e: e[0])
            kept, seen = [], set()
            for e in entries:
                if e[3] in seen:
                    continue
                seen.add(e[3])
                kept.append(e)
                if len(kept) >= n:
                    break
            best[key] = kept
    finals: List[Entry] = []
    for s, c in lat.final_costs.items():
        for (cost, g, ac, w) in best.get((lat.num_frames, s), ()):
            finals.append((cost + lm_scale * c, g + c, ac, w))
    finals.sort(key=lambda e: e[0])
    out, seen = [], set()
    for cost, g, ac, w in finals:
        if w in seen:
            continue
        seen.add(w)
        out.append(NBestEntry(w, cost, g, ac))
        if len(out) >= n:
            break
    return out


def lm_score_words(G: Fst, words: Sequence[int]) -> float:
    """Cost of a word sequence through a G acceptor (inf if rejected)."""
    INF = float("inf")
    best = {G.start: 0.0}

    def eps_close(scores):
        changed = True
        it = 0
        while changed and it < 100:
            changed = False
            it += 1
            for s, w in list(scores.items()):
                for a in G.arcs[s]:
                    if a.ilabel == EPS:
                        nw = w + a.weight
                        if nw < scores.get(a.nextstate, INF) - 1e-12:
                            scores[a.nextstate] = nw
                            changed = True
        return scores

    best = eps_close(best)
    for word in words:
        nxt: Dict[int, float] = {}
        for s, w in best.items():
            for a in G.arcs_with_label(s, word):
                nw = w + a.weight
                if nw < nxt.get(a.nextstate, INF):
                    nxt[a.nextstate] = nw
        if not nxt:
            return INF
        best = eps_close(nxt)
    return min((w + G.finals[s] for s, w in best.items()
                if s in G.finals), default=INF)


def rescore_nbest(
    nbest: List[NBestEntry],
    old_G: Optional[Fst],
    new_G: Fst,
    acoustic_scale: float = 1.0,
    lm_scale: float = 1.0,
) -> List[NBestEntry]:
    """lattice-lmrescore via n-best: swap old-G cost for new-G cost.

    With old_G=None the stored graph cost is kept and the new LM cost
    added (boosting/interpolation-style)."""
    out = []
    for e in nbest:
        new_lm = lm_score_words(new_G, e.words)
        if new_lm == float("inf"):
            continue
        old_lm = (lm_score_words(old_G, e.words)
                  if old_G is not None else 0.0)
        if old_lm == float("inf"):
            old_lm = 0.0
        graph = e.graph_cost - old_lm + new_lm
        out.append(NBestEntry(
            e.words,
            acoustic_scale * e.acoustic_cost + lm_scale * graph,
            graph, e.acoustic_cost,
        ))
    out.sort(key=lambda e: e.total_cost)
    return out
