"""CART decision-tree state tying: training + classification.

Re-implements the reference's classification-and-regression-tree module
(ref: src/Cart/ — Cart::DecisionTree, Cart::TrainingPlan, the
likelihood-gain splitting of tagged examples, XML tree artifacts, and
Am::CartStateTying classification at runtime).

Examples are allophone states tagged with (left, center, right, state)
and carrying pooled diagonal-Gaussian sufficient statistics of their
frames. Questions ask set-membership of one tag position. Splitting is
greedy by likelihood gain of the pooled diag Gaussian, with minimum
observation and gain thresholds. The trained tree classifies any
(possibly unseen) allophone state to a leaf = tied class id, which
Am-style tyings consume (models/tying.CartStateTying).

Training is host-side numpy (it runs once per system build, on tiny
statistics tensors); classification is pure python at graph-compile time
only — decoders bake class ids into dense arrays.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import math
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

Key = Tuple[int, int, int, int]  # (left, center, right, state)
POSITIONS = ("left", "center", "right", "state")


@dataclasses.dataclass(frozen=True)
class Question:
    """Is tag[position] in values? (ref: Cart question sets over phonetic
    categories, e.g. VOWEL-left, NASAL-right.)"""

    position: str  # left | center | right | state
    values: FrozenSet[int]
    name: str = ""

    def ask(self, key: Key) -> bool:
        idx = POSITIONS.index(self.position)
        return key[idx] in self.values


@dataclasses.dataclass
class ExampleStats:
    count: float
    sum: np.ndarray  # [D]
    sumsq: np.ndarray  # [D]

    def merged(self, other: "ExampleStats") -> "ExampleStats":
        return ExampleStats(
            self.count + other.count, self.sum + other.sum, self.sumsq + other.sumsq
        )


class CartExamples:
    """Keyed sufficient statistics; mergeable across jobs like the
    reference's example accumulators."""

    def __init__(self, dim: int):
        self.dim = dim
        self.stats: Dict[Key, ExampleStats] = {}

    def add(self, key: Key, count: float, s: np.ndarray, sq: np.ndarray) -> None:
        if key in self.stats:
            e = self.stats[key]
            e.count += count
            e.sum += s
            e.sumsq += sq
        else:
            self.stats[key] = ExampleStats(float(count), s.astype(np.float64), sq.astype(np.float64))

    def add_frames(self, keys: Sequence[Key], feats: np.ndarray, weights: Optional[np.ndarray] = None) -> None:
        feats = np.asarray(feats, np.float64)
        if weights is None:
            weights = np.ones(len(keys))
        for key, x, w in zip(keys, feats, weights):
            self.add(key, w, w * x, w * x * x)

    def merge(self, other: "CartExamples") -> "CartExamples":
        for k, e in other.stats.items():
            self.add(k, e.count, e.sum, e.sumsq)
        return self


def _pooled_ll(count: float, s: np.ndarray, sq: np.ndarray, var_floor: float = 1e-6) -> float:
    """Log-likelihood of data under its own ML diagonal Gaussian."""
    if count <= 0:
        return 0.0
    mean = s / count
    var = np.maximum(sq / count - mean * mean, var_floor)
    D = s.shape[0]
    return -0.5 * count * (D * math.log(2 * math.pi) + np.log(var).sum() + D)


@dataclasses.dataclass
class _Node:
    node_id: int
    keys: List[Key]
    count: float
    sum: np.ndarray
    sumsq: np.ndarray
    question: Optional[Question] = None
    yes: Optional["_Node"] = None
    no: Optional["_Node"] = None
    leaf_id: int = -1


class CartTree:
    """Trained decision tree mapping tag keys to tied class ids."""

    def __init__(self):
        self.root: Optional[_Node] = None
        self.num_classes = 0
        self._silence_classes: Dict[int, int] = {}  # center phoneme -> class

    # -------------------------------------------------------------- training
    @classmethod
    def train(
        cls,
        examples: CartExamples,
        questions: Sequence[Question],
        max_leaves: int = 100,
        min_gain: float = 0.0,
        min_observations: float = 1.0,
        separate: Optional[Dict[int, Sequence[Key]]] = None,
    ) -> "CartTree":
        """Greedy likelihood-gain splitting (ref: Cart::TrainingPlan).

        ``separate`` optionally pre-assigns whole key groups (e.g. silence)
        to their own classes before tree growing, like the reference's
        forced silence class.
        """
        tree = cls()
        keys = list(examples.stats.keys())
        sep_keys = set()
        if separate:
            for cid_keys in separate.values():
                sep_keys.update(cid_keys)
        keys = [k for k in keys if k not in sep_keys]

        def node_from_keys(node_id, ks):
            cnt = sum(examples.stats[k].count for k in ks)
            s = np.sum([examples.stats[k].sum for k in ks], axis=0) if ks else np.zeros(examples.dim)
            sq = np.sum([examples.stats[k].sumsq for k in ks], axis=0) if ks else np.zeros(examples.dim)
            return _Node(node_id, ks, cnt, s, sq)

        next_id = 0
        root = node_from_keys(next_id, keys)
        next_id += 1
        tree.root = root

        def best_split(node):
            base = _pooled_ll(node.count, node.sum, node.sumsq)
            best = (min_gain, None, None, None)
            for q in questions:
                yes = [k for k in node.keys if q.ask(k)]
                if not yes or len(yes) == len(node.keys):
                    continue
                no = [k for k in node.keys if not q.ask(k)]
                cy = sum(examples.stats[k].count for k in yes)
                cn = node.count - cy
                if cy < min_observations or cn < min_observations:
                    continue
                sy = np.sum([examples.stats[k].sum for k in yes], axis=0)
                qy = np.sum([examples.stats[k].sumsq for k in yes], axis=0)
                gain = (
                    _pooled_ll(cy, sy, qy)
                    + _pooled_ll(cn, node.sum - sy, node.sumsq - qy)
                    - base
                )
                if gain > best[0]:
                    best = (gain, q, yes, no)
            return best

        # priority queue of (-gain, node_id, node, question, yes, no)
        heap = []
        gain, q, yes, no = best_split(root)
        if q is not None:
            heapq.heappush(heap, (-gain, root.node_id, root, q, yes, no))
        leaves = 1
        budget = max_leaves - len(separate or {})
        while heap and leaves < budget:
            _, _, node, q, yes, no = heapq.heappop(heap)
            if node.question is not None:
                continue
            node.question = q
            ny = node_from_keys(next_id, yes); next_id += 1
            nn = node_from_keys(next_id, no); next_id += 1
            node.yes, node.no = ny, nn
            leaves += 1
            for child in (ny, nn):
                g, cq, cyes, cno = best_split(child)
                if cq is not None:
                    heapq.heappush(heap, (-g, child.node_id, child, cq, cyes, cno))

        # assign leaf ids
        cid = 0
        if separate:
            for fixed_cid in sorted(separate):
                tree._silence_classes[fixed_cid] = fixed_cid
            cid = max(separate) + 1
            tree._separate = {k: c for c, ks in separate.items() for k in ks}
        else:
            tree._separate = {}

        def assign(node):
            nonlocal cid
            if node.question is None:
                node.leaf_id = cid
                cid += 1
            else:
                assign(node.yes)
                assign(node.no)

        assign(root)
        tree.num_classes = cid
        return tree

    # ---------------------------------------------------------- classification
    def classify_key(self, key: Key) -> int:
        if key in self._separate:
            return self._separate[key]
        node = self.root
        while node.question is not None:
            node = node.yes if node.question.ask(key) else node.no
        return node.leaf_id

    def classify_allophone_state(self, state, lexicon) -> int:
        al = state.allophone
        return self.classify_key((al.left, al.center, al.right, state.state))

    # ------------------------------------------------------------------- io
    def to_dict(self) -> dict:
        def enc(node):
            if node.question is None:
                return {"leaf": node.leaf_id}
            return {
                "question": {
                    "position": node.question.position,
                    "values": sorted(node.question.values),
                    "name": node.question.name,
                },
                "yes": enc(node.yes),
                "no": enc(node.no),
            }

        return {
            "num_classes": self.num_classes,
            "separate": [[list(k), c] for k, c in self._separate.items()],
            "tree": enc(self.root),
        }

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_dict(), fh)

    @classmethod
    def load(cls, path: str) -> "CartTree":
        with open(path, "r", encoding="utf-8") as fh:
            d = json.load(fh)
        tree = cls()
        tree.num_classes = d["num_classes"]
        tree._separate = {tuple(k): c for k, c in d["separate"]}

        def dec(obj, node_id=[0]):
            n = _Node(node_id[0], [], 0, np.zeros(0), np.zeros(0))
            node_id[0] += 1
            if "leaf" in obj:
                n.leaf_id = obj["leaf"]
            else:
                qd = obj["question"]
                n.question = Question(qd["position"], frozenset(qd["values"]), qd["name"])
                n.yes = dec(obj["yes"])
                n.no = dec(obj["no"])
            return n

        tree.root = dec(d["tree"])
        return tree


def default_questions(lexicon, groups: Optional[Dict[str, Sequence[str]]] = None) -> List[Question]:
    """Singleton phoneme questions for all positions + optional phonetic
    category groups + HMM-state-position questions."""
    qs: List[Question] = []
    ids = [ph.id for ph in lexicon.phonemes]
    for pos in ("left", "center", "right"):
        for pid in ids:
            qs.append(Question(pos, frozenset([pid]), f"{pos}={lexicon.phonemes.by_id(pid).symbol}"))
        if groups:
            for gname, syms in groups.items():
                vals = frozenset(lexicon.phonemes[s].id for s in syms if s in lexicon.phonemes)
                if vals:
                    qs.append(Question(pos, vals, f"{pos}in{gname}"))
        # context-boundary question (word boundary / no context)
        qs.append(Question(pos, frozenset([0]), f"{pos}=#"))
    for st in range(3):
        qs.append(Question("state", frozenset([st]), f"state={st}"))
    return qs
