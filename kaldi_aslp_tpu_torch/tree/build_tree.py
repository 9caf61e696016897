"""Decision-tree state tying for context-dependent phones.

A copy of kaldi_aslp_tpu/tree/build_tree.py (numpy; the port imports
nothing of the JAX package) without its ``acc_tree_stats`` stub and
``ContextDependency.pdf_map`` guard, which only raise.  Equivalent of
the reference tree chain (reference:
src/bin/acc-tree-stats.cc — per (context-window, pdf-class) Gaussian
stats from alignments; src/bin/cluster-phones.cc — automatic question
generation by bottom-up phone clustering; src/tree/build-tree.{h,cc}
BuildTree — greedy top-down likelihood splitting; src/tree/context-dep.h
ContextDependency).

The result maps (phone context window, pdf-class) → pdf id for both
training-graph compilation and decode-graph context expansion."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_aslp_tpu_torch.tree.cluster import (
    GaussStats,
    cluster_bottom_up,
)

Context = Tuple[int, ...]  # phone window, e.g. (left, center, right)
StatsKey = Tuple[Context, int]  # (window, pdf_class)


def stats_from_alignment(
    feats: np.ndarray,
    frame_phones: np.ndarray,      # [T] phone id per frame
    frame_pdf_classes: np.ndarray,  # [T] topology pdf-class per frame
    stats: Optional[Dict[StatsKey, GaussStats]] = None,
    context_width: int = 3,
    central_position: int = 1,
) -> Dict[StatsKey, GaussStats]:
    """(reference: acc-tree-stats.cc AccumulateTreeStats) — the phone
    context of each frame comes from the phone segmentation."""
    stats = stats if stats is not None else {}
    feats = np.asarray(feats, np.float64)
    T = len(frame_phones)
    # phone segmentation: contiguous runs
    seg_bounds = [0]
    for t in range(1, T):
        if frame_phones[t] != frame_phones[t - 1]:
            seg_bounds.append(t)
    seg_bounds.append(T)
    seg_phones = [int(frame_phones[s]) for s in seg_bounds[:-1]]
    for si in range(len(seg_phones)):
        window = []
        for off in range(-central_position,
                         context_width - central_position):
            j = si + off
            window.append(seg_phones[j] if 0 <= j < len(seg_phones)
                          else 0)  # 0 = boundary context
        window = tuple(window)
        for t in range(seg_bounds[si], seg_bounds[si + 1]):
            key = (window, int(frame_pdf_classes[t]))
            if key not in stats:
                stats[key] = GaussStats.zero(feats.shape[1])
            s = stats[key]
            s.count += 1
            s.sum += feats[t]
            s.sumsq += feats[t] ** 2
    return stats


def cluster_phones_into_questions(
    stats: Dict[StatsKey, GaussStats],
    phones: Sequence[int],
    num_questions: int = 10,
) -> List[List[int]]:
    """Automatic question sets by agglomerative phone clustering
    (reference: cluster-phones.cc + steps/train_deltas.sh questions).

    Questions are nested phone sets from the merge hierarchy; we return
    the cluster sets at several granularities plus singletons."""
    # per-phone pooled stats (over all contexts/pdf-classes where the
    # phone is central)
    dim = next(iter(stats.values())).sum.shape[0] if stats else 1
    pooled: Dict[int, GaussStats] = {p: GaussStats.zero(dim)
                                     for p in phones}
    for (window, _pc), s in stats.items():
        center = window[len(window) // 2] if len(window) % 2 else \
            window[len(window) // 2 - 1]
        # central position for (l, c, r) is index 1
        center = window[1] if len(window) == 3 else center
        if center in pooled:
            pooled[center] = pooled[center].add(s)
    plist = [p for p in phones if pooled[p].count > 0]
    questions: List[List[int]] = [[p] for p in plist]
    for k in range(2, min(num_questions, max(len(plist) - 1, 2)) + 1):
        assign = cluster_bottom_up([pooled[p] for p in plist], k)
        for c in set(assign):
            q = sorted(plist[i] for i in range(len(plist))
                       if assign[i] == c)
            if q not in questions:
                questions.append(q)
    questions.append(sorted(plist))
    return questions


@dataclass
class TreeNode:
    # leaf
    pdf: int = -1
    # or split
    key_pos: Optional[int] = None      # context position or -1=pdf_class
    question: Optional[frozenset] = None
    yes: Optional["TreeNode"] = None
    no: Optional["TreeNode"] = None

    @property
    def is_leaf(self) -> bool:
        return self.key_pos is None


class ContextDependency:
    """(reference: src/tree/context-dep.h ContextDependency).

    Maps (context window, pdf_class) → pdf id via per-(central phone,
    pdf_class) decision trees ("roots")."""

    def __init__(self, context_width: int = 3, central_position: int = 1):
        self.context_width = context_width
        self.central_position = central_position
        self.roots: Dict[Tuple[int, int], TreeNode] = {}
        self.num_pdfs = 0

    def compute(self, window: Context, pdf_class: int) -> int:
        node = self.roots.get((window[self.central_position], pdf_class))
        if node is None:
            raise KeyError(
                f"no tree for phone {window[self.central_position]} "
                f"pdf-class {pdf_class}"
            )
        while not node.is_leaf:
            val = window[node.key_pos]
            node = node.yes if val in node.question else node.no
        return node.pdf

    def pdf_map(self):
        """Refused, as in the JAX package: a monophone-style pdf map does
        not describe a context-dependent tree; use ``compute`` with full
        windows."""
        raise TypeError("CD trees need context windows; use compute()")


def build_tree(
    stats: Dict[StatsKey, GaussStats],
    phones: Sequence[int],
    pdf_classes_per_phone: Dict[int, int],
    questions: Optional[List[List[int]]] = None,
    max_leaves: int = 2000,
    min_gain: float = 20.0,
    min_count: float = 10.0,
    context_width: int = 3,
    central_position: int = 1,
) -> ContextDependency:
    """Greedy top-down splitting (reference: build-tree.cc BuildTree,
    build-tree-utils.cc SplitDecisionTree).

    Each (central phone, pdf-class) root is split by (context position,
    question subset) choices maximizing Gaussian likelihood gain."""
    if questions is None:
        questions = cluster_phones_into_questions(stats, phones)
    qsets = [frozenset(q) for q in questions]
    tree = ContextDependency(context_width, central_position)

    # group stats by root
    by_root: Dict[Tuple[int, int], List[Tuple[Context, GaussStats]]] = {}
    for (window, pc), s in stats.items():
        by_root.setdefault(
            (window[central_position], pc), []
        ).append((window, s))

    # leaves allocated globally, splits chosen by a global priority
    # (simplified vs the reference's exact global queue: per-root greedy
    # with a shared leaf budget, largest-gain-first)
    import heapq

    leaves: List[Tuple[TreeNode, List[Tuple[Context, GaussStats]]]] = []
    heap = []
    counter = 0

    def pooled(items):
        total = None
        for _, s in items:
            total = s if total is None else total.add(s)
        return total

    def best_split(items):
        """Find the (pos, question) with max objf gain."""
        if not items:
            return None
        total = pooled(items)
        base = total.objf()
        best = None
        positions = [p for p in range(context_width)
                     if p != central_position]
        for pos in positions:
            for q in qsets:
                yes = [it for it in items if it[0][pos] in q]
                no = [it for it in items if it[0][pos] not in q]
                if not yes or not no:
                    continue
                ys, ns = pooled(yes), pooled(no)
                if ys.count < min_count or ns.count < min_count:
                    continue
                gain = ys.objf() + ns.objf() - base
                if best is None or gain > best[0]:
                    best = (gain, pos, q, yes, no)
        return best

    # every (phone, pdf-class) gets a root even with no observations
    # (starved states keep a single shared leaf, reference: BuildTree
    # ensures all leaves exist via the roots file)
    for phone in phones:
        for pc in range(pdf_classes_per_phone.get(phone, 0)):
            by_root.setdefault((phone, pc), [])
    for root_key, items in sorted(by_root.items()):
        node = TreeNode()
        tree.roots[root_key] = node
        leaves.append((node, items))

    for idx, (node, items) in enumerate(leaves):
        split = best_split(items)
        if split is not None:
            heapq.heappush(heap, (-split[0], counter, idx, split))
            counter += 1

    num_leaves = len(leaves)
    while heap and num_leaves < max_leaves:
        neg_gain, _, idx, (gain, pos, q, yes, no) = heapq.heappop(heap)
        if gain < min_gain:
            break
        node, _items = leaves[idx]
        if not node.is_leaf or node.pdf >= 0:
            continue
        node.key_pos = pos
        node.question = q
        node.yes = TreeNode()
        node.no = TreeNode()
        for child, child_items in ((node.yes, yes), (node.no, no)):
            leaves.append((child, child_items))
            cidx = len(leaves) - 1
            split = best_split(child_items)
            if split is not None:
                heapq.heappush(heap, (-split[0], counter, cidx, split))
                counter += 1
        num_leaves += 1

    # assign pdf ids to leaves in deterministic order
    pdf = 0
    def assign(node: TreeNode):
        nonlocal pdf
        if node.is_leaf:
            node.pdf = pdf
            pdf += 1
        else:
            assign(node.yes)
            assign(node.no)
    for key in sorted(tree.roots):
        assign(tree.roots[key])
    tree.num_pdfs = pdf
    return tree
