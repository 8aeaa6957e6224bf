"""FSA algorithms: compose, determinize, minimize, best, prune, push, …

Re-implements the reference's algorithm set (ref: src/Fsa/Compose.*,
Determinize.*, Best.*, Sssp.*, Minimize.*, Prune.*, Project.*, plus the
rational ops). Eager implementations over :class:`Automaton`; the
reference's lazy/caching machinery is unnecessary host-side (see
automaton.py docstring).
"""

from __future__ import annotations

import heapq
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .automaton import EPS, Arc, Automaton, Tropical


# ------------------------------------------------------------------ reachable
def connect(fsa: Automaton) -> Automaton:
    """Trim to accessible + coaccessible states (ref: Fsa::trim)."""
    n = fsa.num_states
    fwd = [False] * n
    stack = [fsa.initial] if fsa.initial >= 0 else []
    while stack:
        s = stack.pop()
        if fwd[s]:
            continue
        fwd[s] = True
        for a in fsa.arcs[s]:
            stack.append(a.target)
    rev = defaultdict(list)
    for s in range(n):
        for a in fsa.arcs[s]:
            rev[a.target].append(s)
    bwd = [False] * n
    stack = [s for s in fsa.finals if fwd[s]]
    for s in stack:
        bwd[s] = True
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if not bwd[p] and fwd[p]:
                bwd[p] = True
                stack.append(p)
    keep = [s for s in range(n) if fwd[s] and bwd[s]]
    remap = {s: i for i, s in enumerate(keep)}
    out = Automaton(fsa.semiring)
    for _ in keep:
        out.add_state()
    for s in keep:
        for a in fsa.arcs[s]:
            if a.target in remap:
                out.add_arc(remap[s], remap[a.target], a.ilabel, a.olabel, a.weight)
    out.finals = {remap[s]: w for s, w in fsa.finals.items() if s in remap}
    out.initial = remap.get(fsa.initial, -1)
    out.input_symbols = dict(fsa.input_symbols)
    out.output_symbols = dict(fsa.output_symbols)
    return out


# -------------------------------------------------------------------- compose
def compose(a: Automaton, b: Automaton) -> Automaton:
    """Transducer composition (ref: Fsa::compose).

    Filterless product: epsilon moves on either side are always allowed.
    In the tropical semiring (the framework default) duplicate epsilon
    interleavings are harmless (min is idempotent); in the log semiring
    they would double-count path mass — remove epsilons first there.
    """
    sr = a.semiring
    out = Automaton(sr)
    state_map: Dict[Tuple[int, int], int] = {}

    def get(sa: int, sb: int) -> int:
        key = (sa, sb)
        if key not in state_map:
            state_map[key] = out.add_state()
        return state_map[key]

    out.initial = get(a.initial, b.initial)
    stack = [(a.initial, b.initial)]
    seen = {(a.initial, b.initial)}
    while stack:
        sa, sb = stack.pop()
        src = get(sa, sb)
        if sa in a.finals and sb in b.finals:
            out.set_final(src, sr.times(a.finals[sa], b.finals[sb]))

        def push(na, nb, il, ol, w):
            key = (na, nb)
            dst = get(na, nb)
            out.add_arc(src, dst, il, ol, w)
            if key not in seen:
                seen.add(key)
                stack.append(key)

        for aa in a.arcs[sa]:
            if aa.olabel == EPS:
                push(aa.target, sb, aa.ilabel, EPS, aa.weight)
            else:
                for ab in b.arcs[sb]:
                    if ab.ilabel == aa.olabel:
                        push(aa.target, ab.target, aa.ilabel, ab.olabel,
                             sr.times(aa.weight, ab.weight))
        for ab in b.arcs[sb]:
            if ab.ilabel == EPS:
                push(sa, ab.target, EPS, ab.olabel, ab.weight)
    out.input_symbols = dict(a.input_symbols)
    out.output_symbols = dict(b.output_symbols)
    return connect(out)


# ---------------------------------------------------------------- determinize
# ------------------------------------------------------ weight quantization
# determinize/minimize group states by weight EQUALITY; float arithmetic
# noise makes that fragile (two pushed weights equal up to 1e-15 can
# straddle any decimal rounding boundary). The robust contract: weights
# are quantized ONCE at the input to an integer grid (weight_resolution)
# and every derived quantity (subset residuals, pushed potentials,
# signatures) is computed in exact integer arithmetic — ints stored in
# the float weight fields are exact below 2^53, so the existing
# min/plus code runs unchanged.
_QMAX = float(1 << 52)  # saturation: beyond this a cost is effectively inf


def _scale_weights(fsa: Automaton, res: float) -> Automaton:
    out = fsa.copy()
    for arcs in out.arcs:
        for a in arcs:
            a.weight = (
                math.inf if a.weight == math.inf
                else float(min(max(round(a.weight / res), -_QMAX), _QMAX))
            )
    out.finals = {
        s: (
            math.inf if w == math.inf
            else float(min(max(round(w / res), -_QMAX), _QMAX))
        )
        for s, w in out.finals.items()
    }
    return out


def _unscale_weights(fsa: Automaton, res: float) -> Automaton:
    for arcs in fsa.arcs:
        for a in arcs:
            if a.weight != math.inf:
                a.weight = a.weight * res
    fsa.finals = {
        s: (w if w == math.inf else w * res) for s, w in fsa.finals.items()
    }
    return fsa


def _check_eps_cycles(fsa: Automaton) -> None:
    """Validate the epsilon subgraph before closure-based algorithms.

    Tropical: epsilon cycles are fine unless their total weight is
    negative (the relaxation closure then diverges) — detected by
    Bellman-Ford over the eps arcs. Log semiring: any epsilon cycle
    needs the geometric-series closure, which is not implemented —
    clear error instead of a silent wrong answer."""
    n = fsa.num_states
    eps_arcs = [
        (s, a.target, a.weight)
        for s in range(n)
        for a in fsa.arcs[s]
        if a.ilabel == EPS
    ]
    if not eps_arcs:
        return
    # cycle detection (iterative DFS, colors)
    adj = defaultdict(list)
    for s, t, _ in eps_arcs:
        adj[s].append(t)
    color = [0] * n  # 0=white 1=gray 2=black
    has_cycle = False
    for root in range(n):
        if color[root] != 0:
            continue
        stack = [(root, iter(adj[root]))]
        color[root] = 1
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                color[node] = 2
                stack.pop()
                continue
            if color[nxt] == 1:
                has_cycle = True
            elif color[nxt] == 0:
                color[nxt] = 1
                stack.append((nxt, iter(adj[nxt])))
        if has_cycle:
            break
    if not has_cycle:
        return
    if fsa.semiring is not Tropical:
        raise ValueError(
            "epsilon cycles are not supported in this semiring "
            "(the geometric-series closure is not implemented)"
        )
    # tropical: reject negative-weight eps cycles (Bellman-Ford)
    dist = [0.0] * n
    for it in range(n):
        changed = False
        for s, t, w in eps_arcs:
            if dist[s] + w < dist[t] - 1e-12:
                dist[t] = dist[s] + w
                changed = True
        if not changed:
            return
    if changed:
        raise ValueError(
            "negative-weight epsilon cycle: epsilon removal diverges"
        )


def remove_epsilon(fsa: Automaton) -> Automaton:
    """Epsilon removal via closure (acceptor semantics on ilabel;
    ref: Fsa::removeEpsilons). Tropical epsilon cycles are handled by
    relaxation (negative-weight cycles raise); log-semiring epsilon
    cycles raise (see _check_eps_cycles)."""
    _check_eps_cycles(fsa)
    sr = fsa.semiring
    out = Automaton(sr)
    for _ in range(fsa.num_states):
        out.add_state()
    out.initial = fsa.initial
    for s in range(fsa.num_states):
        closure = fsa._eps_closure({s: sr.one})
        for cs, cw in closure.items():
            if cs in fsa.finals:
                w = sr.times(cw, fsa.finals[cs])
                out.finals[s] = sr.plus(out.finals.get(s, sr.zero), w)
            for a in fsa.arcs[cs]:
                if a.ilabel != EPS:
                    out.add_arc(s, a.target, a.ilabel, a.olabel, sr.times(cw, a.weight))
    return connect(out)


def determinize(
    fsa: Automaton,
    weight_resolution: float = 1e-9,
    max_states: int = 100000,
) -> Automaton:
    """Weighted subset determinization over the tropical semiring
    (acceptors; ref: Fsa::determinize).

    Weights are quantized once to the ``weight_resolution`` grid and the
    construction runs in exact integer arithmetic (subset residuals are
    grouped by EQUALITY — see _scale_weights). Weighted determinization
    terminates only for automata with the twins property; cyclic
    automata that violate it would expand forever, so the construction
    raises once ``max_states`` subsets exist."""
    if fsa.semiring is not Tropical:
        raise ValueError("determinization implemented for the tropical semiring")
    q = _scale_weights(fsa, weight_resolution)
    return _unscale_weights(
        _determinize_scaled(q, max_states), weight_resolution
    )


def _determinize_scaled(fsa: Automaton, max_states: int = 100000) -> Automaton:
    """Subset determinization on integer-valued weights (exact)."""
    fsa = remove_epsilon(fsa)
    sr = fsa.semiring
    out = Automaton(sr)
    # subset: frozenset of (state, residual)
    def norm(subset):
        m = min(r for _, r in subset)
        return frozenset((s, r - m) for s, r in subset), m

    init = frozenset({(fsa.initial, 0.0)})
    init, w0 = norm(init)
    state_map = {init: out.add_state()}
    out.initial = state_map[init]
    stack = [init]
    while stack:
        subset = stack.pop()
        src = state_map[subset]
        fin = sr.zero
        for s, r in subset:
            if s in fsa.finals:
                fin = sr.plus(fin, r + fsa.finals[s])
        if fin < math.inf:
            out.set_final(src, fin)
        by_label: Dict[int, Dict[int, float]] = defaultdict(dict)
        for s, r in subset:
            for a in fsa.arcs[s]:
                w = r + a.weight
                old = by_label[a.ilabel].get(a.target, sr.zero)
                by_label[a.ilabel][a.target] = sr.plus(old, w)
        for label, targets in by_label.items():
            subset2, w = norm(frozenset(targets.items()))
            if subset2 not in state_map:
                if len(state_map) >= max_states:
                    raise ValueError(
                        f"determinization exceeded {max_states} subset "
                        f"states — the input likely violates the twins "
                        f"property (weighted cyclic determinization "
                        f"need not terminate)"
                    )
                state_map[subset2] = out.add_state()
                stack.append(subset2)
            out.add_arc(src, state_map[subset2], label, label, w)
    out.input_symbols = dict(fsa.input_symbols)
    out.output_symbols = dict(fsa.input_symbols)
    return out


def minimize(fsa: Automaton, weight_resolution: float = 1e-9) -> Automaton:
    """Weighted minimization = weight pushing + Hopcroft-style partition
    refinement on (label, weight, class) signatures (ref: Fsa::minimize).

    The whole pipeline (determinize, push, refine) runs on the
    ``weight_resolution`` integer grid: pushed potentials are exact
    integer sums, so signature grouping is exact equality — no float
    rounding boundaries (the old round(w, 9) smell)."""
    q = _scale_weights(fsa, weight_resolution)
    fsa = push_weights(_determinize_scaled(q))  # (max_states default)
    n = fsa.num_states
    # initial partition: by (is_final, final weight) — exact int equality
    sig0 = {}
    cls = [0] * n
    for s in range(n):
        key = (s in fsa.finals, fsa.finals.get(s, 0.0))
        cls[s] = sig0.setdefault(key, len(sig0))
    changed = True
    while changed:
        changed = False
        sigs = {}
        new_cls = [0] * n
        for s in range(n):
            arc_sig = tuple(sorted(
                (a.ilabel, a.weight, cls[a.target]) for a in fsa.arcs[s]
            ))
            key = (cls[s], arc_sig)
            new_cls[s] = sigs.setdefault(key, len(sigs))
        if new_cls != cls:
            cls = new_cls
            changed = True
    out = Automaton(fsa.semiring)
    num = max(cls) + 1
    for _ in range(num):
        out.add_state()
    added = set()
    for s in range(n):
        for a in fsa.arcs[s]:
            key = (cls[s], a.ilabel, cls[a.target], a.weight)
            if key not in added:
                added.add(key)
                out.add_arc(cls[s], cls[a.target], a.ilabel, a.olabel, a.weight)
    for s, w in fsa.finals.items():
        out.finals[cls[s]] = w
    out.initial = cls[fsa.initial]
    out.input_symbols = dict(fsa.input_symbols)
    out.output_symbols = dict(fsa.output_symbols)
    return _unscale_weights(connect(out), weight_resolution)


# ------------------------------------------------------------------- shortest
def shortest_distance(fsa: Automaton, reverse: bool = False) -> List[float]:
    """Single-source shortest distances (ref: Fsa::sssp)."""
    sr = fsa.semiring
    n = fsa.num_states
    dist = [sr.zero] * n
    if not reverse:
        if fsa.initial < 0:
            return dist
        dist[fsa.initial] = sr.one
        heap = [(sr.one, fsa.initial)]
        while heap:
            d, s = heapq.heappop(heap)
            if d > dist[s]:
                continue
            for a in fsa.arcs[s]:
                nd = sr.times(d, a.weight)
                if nd < dist[a.target]:
                    dist[a.target] = nd
                    heapq.heappush(heap, (nd, a.target))
    else:
        rev = defaultdict(list)
        for s in range(n):
            for a in fsa.arcs[s]:
                rev[a.target].append((s, a.weight))
        heap = []
        for s, w in fsa.finals.items():
            dist[s] = w
            heapq.heappush(heap, (w, s))
        while heap:
            d, s = heapq.heappop(heap)
            if d > dist[s]:
                continue
            for p, w in rev[s]:
                nd = sr.times(w, d)
                if nd < dist[p]:
                    dist[p] = nd
                    heapq.heappush(heap, (nd, p))
    return dist


def best(fsa: Automaton) -> Tuple[float, List[Arc]]:
    """Best path (ref: Fsa::best)."""
    sr = fsa.semiring
    dist = [sr.zero] * fsa.num_states
    back: List[Optional[Tuple[int, Arc]]] = [None] * fsa.num_states
    dist[fsa.initial] = sr.one
    heap = [(sr.one, fsa.initial)]
    while heap:
        d, s = heapq.heappop(heap)
        if d > dist[s]:
            continue
        for a in fsa.arcs[s]:
            nd = d + a.weight
            if nd < dist[a.target]:
                dist[a.target] = nd
                back[a.target] = (s, a)
                heapq.heappush(heap, (nd, a.target))
    best_final = (math.inf, -1)
    for s, w in fsa.finals.items():
        if dist[s] + w < best_final[0]:
            best_final = (dist[s] + w, s)
    if best_final[1] < 0:
        return math.inf, []
    path = []
    s = best_final[1]
    while back[s] is not None:
        p, a = back[s]
        path.append(a)
        s = p
    path.reverse()
    return best_final[0], path


def n_best_paths(fsa: Automaton, n: int) -> List[Tuple[float, List[int]]]:
    """N best label sequences (ref: Fsa::nbest)."""
    results = []
    seen = set()
    heap = [(0.0, 0, fsa.initial, [])]
    counter = 1
    while heap and len(results) < n:
        cost, _, s, labels = heapq.heappop(heap)
        if s in fsa.finals:
            key = tuple(labels)
            if key not in seen:
                seen.add(key)
                results.append((cost + fsa.finals[s], labels))
        for a in fsa.arcs[s]:
            counter += 1
            heapq.heappush(
                heap,
                (cost + a.weight, counter, a.target,
                 labels + ([a.ilabel] if a.ilabel != EPS else [])),
            )
    return results


def prune(fsa: Automaton, threshold: float) -> Automaton:
    """Keep states/arcs within threshold of the best path
    (ref: Fsa::prune fwd/bwd)."""
    fwd = shortest_distance(fsa)
    bwd = shortest_distance(fsa, reverse=True)
    best_cost = min(
        (fwd[s] + w for s, w in fsa.finals.items()), default=math.inf
    )
    out = fsa.copy()
    for s in range(out.num_states):
        out.arcs[s] = [
            a for a in out.arcs[s]
            if fwd[s] + a.weight + bwd[a.target] <= best_cost + threshold
        ]
    out.finals = {
        s: w for s, w in out.finals.items() if fwd[s] + w <= best_cost + threshold
    }
    return connect(out)


def push_weights(fsa: Automaton) -> Automaton:
    """Weight pushing toward the initial state (ref: Fsa::pushWeights)."""
    bwd = shortest_distance(fsa, reverse=True)
    out = fsa.copy()
    for s in range(out.num_states):
        if bwd[s] == math.inf:
            continue
        for a in out.arcs[s]:
            if bwd[a.target] < math.inf:
                a.weight = a.weight + bwd[a.target] - bwd[s]
    for s in list(out.finals):
        out.finals[s] = out.finals[s] - bwd[s]
    # fold total cost into initial arcs? keep as residual on initial state:
    # the conventional form adds it to the start; record in finals if no arcs
    if out.initial >= 0 and bwd[out.initial] < math.inf:
        total = bwd[out.initial]
        for a in out.arcs[out.initial]:
            pass  # total is carried implicitly: best() == total preserved below
        # add the total back on initial arcs so path costs are unchanged
        for a in out.arcs[out.initial]:
            a.weight += total
        if out.initial in out.finals:
            out.finals[out.initial] += total
    return out


def project(fsa: Automaton, side: str = "input") -> Automaton:
    """Project transducer to acceptor (ref: Fsa::project*)."""
    out = fsa.copy()
    for arcs in out.arcs:
        for a in arcs:
            if side == "input":
                a.olabel = a.ilabel
            else:
                a.ilabel = a.olabel
    if side == "output":
        out.input_symbols = dict(fsa.output_symbols)
    else:
        out.output_symbols = dict(fsa.input_symbols)
    return out


def invert(fsa: Automaton) -> Automaton:
    """Swap input/output labels (ref: Fsa::invert)."""
    out = fsa.copy()
    for arcs in out.arcs:
        for a in arcs:
            a.ilabel, a.olabel = a.olabel, a.ilabel
    out.input_symbols, out.output_symbols = (
        dict(fsa.output_symbols), dict(fsa.input_symbols),
    )
    return out


def union(a: Automaton, b: Automaton) -> Automaton:
    """Union via new initial state (ref: rational ops)."""
    out = Automaton(a.semiring)
    start = out.add_state()
    out.initial = start
    offset_a = out.num_states
    for _ in range(a.num_states):
        out.add_state()
    for s in range(a.num_states):
        for arc in a.arcs[s]:
            out.add_arc(offset_a + s, offset_a + arc.target, arc.ilabel, arc.olabel, arc.weight)
    for s, w in a.finals.items():
        out.set_final(offset_a + s, w)
    offset_b = out.num_states
    for _ in range(b.num_states):
        out.add_state()
    for s in range(b.num_states):
        for arc in b.arcs[s]:
            out.add_arc(offset_b + s, offset_b + arc.target, arc.ilabel, arc.olabel, arc.weight)
    for s, w in b.finals.items():
        out.set_final(offset_b + s, w)
    out.add_arc(start, offset_a + a.initial, EPS, EPS, 0.0)
    out.add_arc(start, offset_b + b.initial, EPS, EPS, 0.0)
    return out


def concatenate(a: Automaton, b: Automaton) -> Automaton:
    out = Automaton(a.semiring)
    for _ in range(a.num_states + b.num_states):
        out.add_state()
    for s in range(a.num_states):
        for arc in a.arcs[s]:
            out.add_arc(s, arc.target, arc.ilabel, arc.olabel, arc.weight)
    ofs = a.num_states
    for s in range(b.num_states):
        for arc in b.arcs[s]:
            out.add_arc(ofs + s, ofs + arc.target, arc.ilabel, arc.olabel, arc.weight)
    for s, w in a.finals.items():
        out.add_arc(s, ofs + b.initial, EPS, EPS, w)
    for s, w in b.finals.items():
        out.set_final(ofs + s, w)
    out.initial = a.initial
    return out
