"""Context expansion: phone graphs → context-window graphs (the "C" step).

A copy of kaldi_aslp_tpu/fst/context.py on the port's own ``fst.py``
(plain Python; the port imports nothing of the JAX package).
Equivalent of the reference context FST (reference:
src/fstext/context-fst.{h,cc} ContextFst used by fstcomposecontext in
utils/mkgraph.sh).  Instead of composing with an on-demand C transducer,
the LG graph is directly rewritten by subset construction: each state
carries the phone history and one pending phone; emitting a phone's
context window is delayed until its right context is known, and pending
phones are flushed with boundary context (0) at final states.

Currently supports the standard triphone case N=3, P=1 and the trivial
N=1 (identity)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from kaldi_aslp_tpu_torch.fst.fst import EPS, Arc, Fst

Context = Tuple[int, ...]


class ContextWindows:
    """Interning table: context window ↔ dense id (ids from 1; 0 = eps)."""

    def __init__(self):
        self._win2id: Dict[Context, int] = {}
        self._windows: List[Context] = [()]  # index 0 unused

    def id(self, window: Context) -> int:
        if window not in self._win2id:
            self._win2id[window] = len(self._windows)
            self._windows.append(window)
        return self._win2id[window]

    def window(self, wid: int) -> Context:
        return self._windows[wid]

    def __len__(self) -> int:
        return len(self._windows) - 1

    def all_windows(self) -> List[Context]:
        return self._windows[1:]


def compose_context(
    lg: Fst, context_width: int = 3, central_position: int = 1
) -> Tuple[Fst, ContextWindows]:
    """LG (phones on ilabels) → CLG (window ids on ilabels).

    (reference: fstbin/fstcomposecontext.cc behavior)."""
    if context_width == 1:
        # monophone: windows are (phone,)
        table = ContextWindows()
        out = Fst()
        for _ in range(lg.num_states):
            out.add_state()
        out.set_start(lg.start)
        for s, w in lg.finals.items():
            out.set_final(s, w)
        for s in range(lg.num_states):
            for a in lg.arcs[s]:
                il = table.id((a.ilabel,)) if a.ilabel != EPS else EPS
                out.add_arc(s, Arc(il, a.olabel, a.weight, a.nextstate))
        return out, table
    if context_width != 3 or central_position != 1:
        raise NotImplementedError("only triphone (3,1) and mono (1,0)")

    table = ContextWindows()
    out = Fst()
    # state = (lg_state, prev_phone, pending_phone); pending=0 → none
    state_map: Dict[Tuple[int, int, int], int] = {}
    from collections import deque

    def get(key):
        if key not in state_map:
            state_map[key] = out.add_state()
        return state_map[key]

    start_key = (lg.start, 0, 0)
    out.set_start(get(start_key))
    queue = deque([start_key])
    seen = {start_key}

    def push(key):
        if key not in seen:
            seen.add(key)
            queue.append(key)

    while queue:
        key = queue.popleft()
        lg_s, prev, pending = key
        cur = get(key)
        if lg_s in lg.finals:
            if pending == 0:
                out.set_final(cur, lg.finals[lg_s])
            else:
                # flush the pending phone with right boundary context
                wid = table.id((prev, pending, 0))
                fkey = ("final-flush", lg_s, pending)
                fstate = get(fkey)  # type: ignore[arg-type]
                out.add_arc(cur, Arc(wid, EPS, 0.0, fstate))
                out.set_final(fstate, lg.finals[lg_s])
        for a in lg.arcs[lg_s]:
            if a.ilabel == EPS:
                nkey = (a.nextstate, prev, pending)
                push(nkey)
                out.add_arc(cur, Arc(EPS, a.olabel, a.weight, get(nkey)))
            else:
                p = a.ilabel
                if pending == 0:
                    nkey = (a.nextstate, prev, p)
                    push(nkey)
                    out.add_arc(cur, Arc(EPS, a.olabel, a.weight,
                                         get(nkey)))
                else:
                    wid = table.id((prev, pending, p))
                    nkey = (a.nextstate, pending, p)
                    push(nkey)
                    out.add_arc(cur, Arc(wid, a.olabel, a.weight,
                                         get(nkey)))
    return out.connect(), table
