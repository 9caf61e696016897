"""Exact dense Viterbi over packed WFST arc arrays, in PyTorch.

Port of kaldi_aslp_tpu/decoder/viterbi.py (``PackedGraph``,
``_eps_diameter``, ``_split``, ``_eps_relax_host``, ``_viterbi_scan``,
``ViterbiDecoder``; reference: src/decoder/faster-decoder.h:61).

The DP is dense over graph states: per frame one segment max over the
emitting arcs (``scatter_reduce(..., "amax")``), then K rounds of epsilon
relaxation, K = the graph's epsilon diameter.  Backpointers are arc ids
and the backtrace runs on the host.  The winning arc of a state is the
largest arc id among its arcs within 1e-6 of the state's best score,
exactly as in the JAX scan (viterbi.py:130-135, :147-151), so ties give
the same words and alignments.

The JAX decoder pads arcs (cost 1e30, id -1), states (to 64) and chunk
lengths so XLA compiles few programs.  PyTorch runs eagerly, so the port
does not pad.

``align_batched`` (viterbi.py:342-425) aligns many utterances, each on
its own training graph, in one frame loop: a batch's graphs are laid
side by side as one graph (disjoint state and arc ranges), each
utterance's loglikes in its own column block, each state's score held
past its utterance's last frame.  No arc is padded, so none can win
where it should not, and the tie rule above picks the same arc: the
arcs into one state all come from one utterance, their ids shifted by
the same offset.  ``equal_align`` (:426-517) is the host copy."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.fst.fst import Fst
from kaldi_aslp_tpu_torch.utils.device import resolve_device

NEG_INF = -1e30


class DecodeError(RuntimeError):
    """The graph holds no complete path for these scores (the only
    failure a caller may score as an empty hypothesis; a fault of the
    card stays a plain RuntimeError)."""


@dataclass
class PackedGraph:
    """Host-side packed form of an Fst for the dense DP."""

    src: np.ndarray
    dst: np.ndarray
    ilabel: np.ndarray   # transition-ids; 0 = eps
    olabel: np.ndarray
    weight: np.ndarray   # costs (-log prob)
    final: np.ndarray    # [S] final costs (inf = non-final)
    start: int
    num_states: int
    eps_diameter: int

    @classmethod
    def from_fst(cls, fst: Fst) -> "PackedGraph":
        arrs = fst.to_arrays()
        eps_mask = arrs["ilabel"] == 0
        diameter = _eps_diameter(
            arrs["src"][eps_mask], arrs["dst"][eps_mask],
            arrs["num_states"])
        return cls(
            src=arrs["src"], dst=arrs["dst"], ilabel=arrs["ilabel"],
            olabel=arrs["olabel"], weight=arrs["weight"],
            final=arrs["final"], start=arrs["start"],
            num_states=arrs["num_states"], eps_diameter=diameter)


def _eps_diameter(src: np.ndarray, dst: np.ndarray, n: int) -> int:
    """Longest eps-arc chain.  The scan does exactly this many
    relaxation rounds per frame, so under-estimating it silently
    produces wrong scores; eps cycles (no finite diameter) are a hard
    error: run remove-eps/determinize on the graph first."""
    if len(src) == 0:
        return 0
    depth = np.zeros(n, np.int32)
    for _ in range(n + 1):
        new = depth.copy()
        np.maximum.at(new, dst, depth[src] + 1)
        if (new == depth).all():
            return int(depth.max())
        depth = new
    raise ValueError(
        "epsilon-cycle detected in decode graph: epsilon relaxation does "
        "not converge; remove epsilon cycles (determinize/rmepsilon) "
        "before packing")


def _split(graph: PackedGraph):
    em = graph.ilabel > 0
    ep = ~em
    return (
        (graph.src[em], graph.dst[em], graph.ilabel[em],
         graph.weight[em], np.where(em)[0]),
        (graph.src[ep], graph.dst[ep], graph.weight[ep], np.where(ep)[0]),
    )


def _eps_relax_host(scores: np.ndarray, bp: np.ndarray,
                    eps_arcs, iters: int):
    """Host epsilon relaxation for the initial state distribution."""
    src, dst, w, idx = eps_arcs
    for _ in range(max(iters, 1)):
        if len(src) == 0:
            break
        cand = scores[src] - w
        for a in range(len(src)):
            if cand[a] > scores[dst[a]]:
                scores[dst[a]] = cand[a]
                bp[dst[a]] = idx[a]
    return scores, bp


def _seg_max_arg(cand, dst, arc_ids, num_states):
    """Per destination state: the best candidate score (at least NEG_INF)
    and the largest arc id within 1e-6 of it (-1 where no arc).
    ``cand`` [..., A] may have leading batch dimensions (one score table
    a row, decoder/batched.py); ``dst`` and ``arc_ids`` are [A]."""
    lead = cand.shape[:-1]
    idx = dst.expand(*lead, -1)
    best = torch.full((*lead, num_states), NEG_INF, dtype=cand.dtype,
                      device=cand.device)
    best = best.scatter_reduce(-1, idx, cand, reduce="amax",
                               include_self=True)
    is_best = cand >= best.gather(-1, idx) - 1e-6
    winner = torch.full((*lead, num_states), -1, dtype=arc_ids.dtype,
                        device=cand.device)
    winner = winner.scatter_reduce(
        -1, idx, torch.where(is_best, arc_ids, -1), reduce="amax",
        include_self=True)
    return best, winner


class _DeviceArcs:
    """The emitting and epsilon arcs of a graph as tensors on a device."""

    def __init__(self, em, ep, tid_to_pdf: np.ndarray,
                 device: torch.device):
        em_src, em_dst, em_il, em_w, em_idx = em
        ep_src, ep_dst, ep_w, ep_idx = ep

        def t(a, dtype):
            return torch.from_numpy(np.asarray(a)).to(device, dtype)

        self.em_src, self.em_dst = t(em_src, torch.long), t(em_dst, torch.long)
        self.em_pdf = t(tid_to_pdf[em_il], torch.long)
        self.em_w, self.em_idx = t(em_w, torch.float32), t(em_idx, torch.long)
        self.ep_src, self.ep_dst = t(ep_src, torch.long), t(ep_dst, torch.long)
        self.ep_w, self.ep_idx = t(ep_w, torch.float32), t(ep_idx, torch.long)


def _viterbi_scan(loglikes: torch.Tensor, init_scores: torch.Tensor,
                  arcs: _DeviceArcs, acoustic_scale: float,
                  num_states: int, eps_iters: int,
                  valid: Optional[torch.Tensor] = None):
    """Returns (final_scores [B, S], bp [T, B, S] arc ids) for
    ``loglikes [B, T, P]`` (kaldi_aslp_tpu/decoder/viterbi.py:_viterbi_scan;
    B > 1 is decoder/batched.py's vmap).  ``valid`` [B, T] marks each
    row's frames, or [B, T, S] each state's (``align_batched``'s side by
    side graphs); a score holds through the frames past its length."""
    scores = init_scores.expand(loglikes.shape[0], -1)
    all_bps = []
    for t in range(loglikes.shape[1]):
        acoustic = acoustic_scale * loglikes[:, t, arcs.em_pdf]
        cand = scores[:, arcs.em_src] - arcs.em_w + acoustic
        new_scores, bp = _seg_max_arg(cand, arcs.em_dst, arcs.em_idx,
                                      num_states)
        bp = torch.where(new_scores > NEG_INF, bp, -1)
        if len(arcs.ep_src) > 0:
            for _ in range(eps_iters):
                cand_e = new_scores[:, arcs.ep_src] - arcs.ep_w
                best, winner = _seg_max_arg(cand_e, arcs.ep_dst,
                                            arcs.ep_idx, num_states)
                improved = best > new_scores
                new_scores = torch.where(improved, best, new_scores)
                bp = torch.where(improved, winner, bp)
        if valid is not None:
            vt = valid[:, t]
            new_scores = torch.where(vt if vt.dim() == 2 else vt[:, None],
                                     new_scores, scores)
        scores = new_scores
        all_bps.append(bp)
    return scores, torch.stack(all_bps)


class ViterbiDecoder:
    """Exact Viterbi decode/align over a packed graph.

    decode(loglikes) -> (words, alignment, score); loglikes are [T, P]
    per-pdf acoustic log-likelihoods, mapped from transition ids by the
    ``tid_to_pdf`` LUT (reference: DecodableMatrixScaledMapped)."""

    def __init__(self, graph: PackedGraph, tid_to_pdf: np.ndarray,
                 acoustic_scale: float = 1.0,
                 word_ins_penalty: float = 0.0,
                 device: Union[str, torch.device] = "cuda"):
        if word_ins_penalty:
            # extra cost on every word-emitting arc (reference:
            # --word-ins-penalty in the scoring sweep)
            graph = PackedGraph(
                graph.src, graph.dst, graph.ilabel, graph.olabel,
                graph.weight + word_ins_penalty * (graph.olabel > 0),
                graph.final, graph.start, graph.num_states,
                graph.eps_diameter)
        self.graph = graph
        self.tid_to_pdf = np.asarray(tid_to_pdf, np.int64)
        self.acoustic_scale = float(acoustic_scale)
        self.device = resolve_device(device)
        self._em, self._ep = _split(graph)
        self._arcs = _DeviceArcs(self._em, self._ep, self.tid_to_pdf,
                                 self.device)

    def _init(self) -> Tuple[np.ndarray, np.ndarray]:
        """Start-state scores + host eps closure backpointers."""
        return _init_scores(self.graph, self._ep)

    def _scan(self, loglikes: np.ndarray, init: np.ndarray):
        """Run the DP on the decoder's device; host (final, bps)."""
        final, bps = self._scan_batch(
            torch.from_numpy(np.array(loglikes, np.float32)
                             ).to(self.device)[None],
            torch.from_numpy(init).to(self.device))
        return final[0].cpu().numpy(), bps[:, 0].cpu().numpy()

    def _scan_batch(self, loglikes: torch.Tensor, init: torch.Tensor,
                    valid: Optional[torch.Tensor] = None):
        """The DP over [B, T, P] device scores: (final [B, S], bp [T, B,
        S])."""
        g = self.graph
        return _viterbi_scan(loglikes, init, self._arcs, self.acoustic_scale,
                             g.num_states, max(g.eps_diameter, 1), valid)

    def decode(self, loglikes: np.ndarray
               ) -> Tuple[List[int], np.ndarray, float]:
        T = loglikes.shape[0]
        init, init_bp = self._init()
        if T > 0:
            final_scores, bps = self._scan(loglikes, init)
        else:
            final_scores = init
            bps = np.zeros((0, self.graph.num_states), np.int64)
        return self._finish(final_scores, bps, T, init_bp)

    def _finish(self, final_scores: np.ndarray, bps: np.ndarray,
                T: int, init_bp: np.ndarray
                ) -> Tuple[List[int], np.ndarray, float]:
        return _backtrace(self.graph, final_scores, bps, T, init_bp)


def _init_scores(graph: PackedGraph, ep) -> Tuple[np.ndarray, np.ndarray]:
    """Start-state scores + host eps closure backpointers."""
    init = np.full(graph.num_states, NEG_INF, np.float32)
    init[graph.start] = 0.0
    init_bp = np.full(graph.num_states, -1, np.int64)
    return _eps_relax_host(init, init_bp, ep, graph.eps_diameter)


def _backtrace(g: PackedGraph, final_scores: np.ndarray, bps: np.ndarray,
               T: int, init_bp: np.ndarray
               ) -> Tuple[List[int], np.ndarray, float]:
    """Final-state selection + host backtrace through arc-id
    backpointers."""
    total = final_scores - g.final
    end_state = int(np.argmax(total))
    if not np.isfinite(total[end_state]) or total[end_state] <= NEG_INF:
        raise DecodeError("no complete path found (empty decode)")
    ali = np.zeros(T, np.int32)
    words_rev: List[int] = []
    s = end_state
    t = T - 1
    while t >= 0:
        a = int(bps[t, s])
        if a < 0:
            raise DecodeError(f"broken backpointer at t={t} s={s}")
        if g.olabel[a] > 0:
            words_rev.append(int(g.olabel[a]))
        if g.ilabel[a] > 0:
            ali[t] = g.ilabel[a]
            t -= 1
        s = int(g.src[a])
    # initial epsilon chain (before frame 0)
    while s != g.start:
        a = int(init_bp[s])
        if a < 0:
            break
        if g.olabel[a] > 0:
            words_rev.append(int(g.olabel[a]))
        s = int(g.src[a])
    return list(reversed(words_rev)), ali, float(total[end_state])


def align_batched(graphs: Dict[str, Union[PackedGraph, Fst]],
                  tid_to_pdf: np.ndarray,
                  loglikes: Dict[str, np.ndarray],
                  acoustic_scale: float = 1.0, batch: int = 64,
                  device: Union[str, torch.device] = "cuda") -> dict:
    """Exact Viterbi alignment of many utterances, each over its own
    training graph, ``batch`` utterances a frame loop on ``device`` (the
    gmm-align-compiled role at corpus granularity; reference:
    steps/align_si.sh).

    ``graphs``/``loglikes``: dicts utt -> PackedGraph (or Fst) / [T, P]
    array.  Returns utt -> (words, alignment, score) like
    ViterbiDecoder.decode; utterances of similar length share a batch."""
    dev = resolve_device(device)
    lut = np.asarray(tid_to_pdf, np.int64)
    packed = {u: g if isinstance(g, PackedGraph) else PackedGraph.from_fst(g)
              for u, g in graphs.items()}
    utts = sorted(packed, key=lambda u: (len(loglikes[u]), u))
    out = {}
    for i0 in range(0, len(utts), batch):
        chunk = utts[i0:i0 + batch]
        out.update(_align_side_by_side(
            chunk, [packed[u] for u in chunk],
            [np.asarray(loglikes[u], np.float32) for u in chunk],
            lut, acoustic_scale, dev))
    return out


def _align_side_by_side(utts: Sequence[str], graphs: Sequence[PackedGraph],
                        lls: Sequence[np.ndarray], lut: np.ndarray,
                        acoustic_scale: float, dev: torch.device) -> dict:
    """One frame loop over the utterances' graphs laid side by side:
    utterance b's states and arcs are shifted past those of 0..b-1 and
    its arcs read the loglike columns [b P, (b+1) P)."""
    B = len(utts)
    P = lls[0].shape[1]
    lens = [len(x) for x in lls]
    T = max(lens)
    ems, eps, inits, init_bps, s_offs, a_offs = [], [], [], [], [], []
    s_off = a_off = 0
    for b, g in enumerate(graphs):
        (es, ed, eil, ew, ei), (ps, pd, pw, pi) = _split(g)
        ini, ibp = _init_scores(g, (ps, pd, pw, pi))
        ems.append((es + s_off, ed + s_off, lut[eil] + b * P, ew, ei + a_off))
        eps.append((ps + s_off, pd + s_off, pw, pi + a_off))
        inits.append(ini)
        init_bps.append(ibp)
        s_offs.append(s_off)
        a_offs.append(a_off)
        s_off += g.num_states
        a_off += len(g.src)
    em = tuple(np.concatenate(cols) for cols in zip(*ems))
    ep = tuple(np.concatenate(cols) for cols in zip(*eps))
    # the emitting arcs' "ids" are already loglike columns: map them
    # through the identity
    arcs = _DeviceArcs(em, ep, np.arange(B * P), dev)
    ll = np.zeros((T, B, P), np.float32)
    for b, x in enumerate(lls):
        ll[:len(x), b] = x
    state_len = np.repeat(lens, [g.num_states for g in graphs])
    valid = np.arange(T)[:, None] < state_len[None, :]
    eps_iters = max(max(g.eps_diameter for g in graphs), 1)
    if T > 0:
        final, bps = _viterbi_scan(
            torch.from_numpy(ll.reshape(1, T, B * P)).to(dev),
            torch.from_numpy(np.concatenate(inits)).to(dev), arcs,
            float(acoustic_scale), s_off, eps_iters,
            torch.from_numpy(valid[None]).to(dev))
        final, bps = final[0].cpu().numpy(), bps[:, 0].cpu().numpy()
    else:
        final, bps = np.concatenate(inits), np.zeros((0, s_off), np.int64)
    out = {}
    for b, (u, g) in enumerate(zip(utts, graphs)):
        cols = slice(s_offs[b], s_offs[b] + g.num_states)
        bp = bps[:lens[b], cols]
        out[u] = _backtrace(g, final[cols],
                            np.where(bp >= 0, bp - a_offs[b], -1),
                            lens[b], init_bps[b])
    return out


def equal_align(graph_fst: Fst, trans_model, num_frames: int,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Uniform initial alignment (reference: bin/align-equal-compiled.cc):
    pick a path through the graph and stretch it over num_frames by
    inserting self-loops.

    The path chosen is the LONGEST acyclic path fitting num_frames, so
    optional-silence branches are taken and silence models receive
    occupancy from iteration 0 (the reference gets this from its random
    path choice + --boost-silence)."""
    # longest-emitting-arcs path over the graph's DFS-forward DAG
    # (back edges, e.g. the 5-state silence topology's backward
    # transitions, are dropped; they never extend a simple path anyway)
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {graph_fst.start: GRAY}
    order = []
    dag_arcs = []  # (src, arc) with no self-loops / back edges
    stack = [(graph_fst.start, iter(graph_fst.arcs[graph_fst.start]))]
    while stack:
        s, it = stack[-1]
        advanced = False
        for a in it:
            if a.nextstate == s:
                continue
            c = color.get(a.nextstate, WHITE)
            if c == GRAY:
                continue  # back edge
            dag_arcs.append((s, a))
            if c == WHITE:
                color[a.nextstate] = GRAY
                stack.append(
                    (a.nextstate, iter(graph_fst.arcs[a.nextstate])))
                advanced = True
                break
        if not advanced:
            color[s] = BLACK
            order.append(s)
            stack.pop()
    topo_pos = {s: i for i, s in enumerate(reversed(order))}
    dag_by_src: Dict[int, list] = {}
    for s, a in dag_arcs:
        dag_by_src.setdefault(s, []).append(a)
    best_len: Dict[int, int] = {graph_fst.start: 0}
    prev: Dict[int, Tuple[int, object]] = {graph_fst.start: (-1, None)}
    for s in sorted(topo_pos, key=topo_pos.get):
        if s not in best_len:
            continue
        for a in dag_by_src.get(s, ()):
            cand = best_len[s] + (1 if a.ilabel > 0 else 0)
            if cand > best_len.get(a.nextstate, -1) and \
                    cand <= num_frames:
                best_len[a.nextstate] = cand
                prev[a.nextstate] = (s, a)
    finals = [s for s in graph_fst.finals if s in best_len]
    if not finals:
        raise RuntimeError("graph has no accepting path within frames")
    end = max(finals, key=lambda s: best_len[s])
    path = []
    s = end
    while prev[s][1] is not None:
        p, a = prev[s]
        path.append(a)
        s = p
    path.reverse()
    emitting = [a for a in path if a.ilabel > 0]
    n = len(emitting)
    if n == 0 or num_frames < n:
        raise RuntimeError(
            f"cannot equal-align {n} states into {num_frames} frames")
    # distribute extra frames as self-loops after each emitting arc
    base = num_frames // n
    extra = num_frames % n
    ali = []
    for i, a in enumerate(emitting):
        count = base + (1 if i < extra else 0)
        ts, _ = trans_model.tid_to_arc(a.ilabel)
        self_tid = None
        for ai, (dest, _p) in enumerate(trans_model.arcs_of(ts)):
            if dest == trans_model.states[ts].hmm_state:
                self_tid = trans_model.pair_to_tid(ts, ai)
                break
        # occupying a state for k frames consumes (k-1) self-loop arcs
        # then the forward arc (all emit the state's pdf)
        if count > 1:
            if self_tid is None:
                raise RuntimeError("state has no self-loop for stretching")
            ali.extend([self_tid] * (count - 1))
        ali.append(a.ilabel)
    return np.asarray(ali, np.int32)
