"""WER / edit-distance evaluation.

Re-implements the reference's evaluation paths
(ref: src/Flf/Evaluator.cc offline lattice evaluation; the online edit
distance in src/Speech/Recognizer.* producing per-segment <recognized>
statistics): Levenshtein alignment with substitution/insertion/deletion
counts, corpus aggregation, and lattice oracle WER.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class EditStats:
    substitutions: int = 0
    insertions: int = 0
    deletions: int = 0
    reference_length: int = 0

    @property
    def errors(self) -> int:
        return self.substitutions + self.insertions + self.deletions

    @property
    def wer(self) -> float:
        return self.errors / self.reference_length if self.reference_length else 0.0

    def add(self, other: "EditStats") -> "EditStats":
        self.substitutions += other.substitutions
        self.insertions += other.insertions
        self.deletions += other.deletions
        self.reference_length += other.reference_length
        return self

    def report(self) -> Dict[str, float]:
        return {
            "wer": self.wer,
            "errors": self.errors,
            "sub": self.substitutions,
            "ins": self.insertions,
            "del": self.deletions,
            "ref_len": self.reference_length,
        }


def align_tokens(
    ref: Sequence[str], hyp: Sequence[str]
) -> Tuple[EditStats, List[Tuple[str, str, str]]]:
    """Levenshtein alignment. Returns stats + ops list
    (op, ref_token, hyp_token) with op in {match, sub, ins, del}."""
    R, H = len(ref), len(hyp)
    dp = np.zeros((R + 1, H + 1), np.int32)
    dp[:, 0] = np.arange(R + 1)
    dp[0, :] = np.arange(H + 1)
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            sub = dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dp[i, j] = min(sub, dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    ops: List[Tuple[str, str, str]] = []
    i, j = R, H
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            ops.append(
                ("match" if ref[i - 1] == hyp[j - 1] else "sub", ref[i - 1], hyp[j - 1])
            )
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            ops.append(("del", ref[i - 1], ""))
            i -= 1
        else:
            ops.append(("ins", "", hyp[j - 1]))
            j -= 1
    ops.reverse()
    stats = EditStats(
        substitutions=sum(1 for o in ops if o[0] == "sub"),
        insertions=sum(1 for o in ops if o[0] == "ins"),
        deletions=sum(1 for o in ops if o[0] == "del"),
        reference_length=R,
    )
    return stats, ops


class CorpusEvaluator:
    """Aggregates WER over segments (the per-segment + corpus-total
    reporting of the reference's recognizer/evaluator)."""

    def __init__(self) -> None:
        self.total = EditStats()
        self.segments: List[Dict] = []

    def add(self, segment: str, ref: str, hyp: str) -> EditStats:
        stats, _ = align_tokens(ref.split(), hyp.split())
        self.total.add(stats)
        self.segments.append({"segment": segment, "ref": ref, "hyp": hyp, **stats.report()})
        return stats

    def report(self) -> Dict[str, float]:
        return self.total.report()


def lattice_oracle(
    lat, ref: Sequence[str], ignore=lambda w: w.startswith("[")
) -> Tuple[int, List[str]]:
    """Oracle (minimum achievable) WER over all lattice paths
    (ref: Flf oracle alignment). DP over (node, ref position).

    ``ignore`` marks non-scored tokens (silence/noise markers, the
    reference's empty eval-token lemmata) that traverse as epsilon."""
    order = lat.topological_order()
    out = lat.out_arcs()
    R = len(ref)
    INF = 1 << 30
    # dist[node][j] = min edits to reach node having consumed ref[:j]
    dist = {n: np.full(R + 1, INF, np.int64) for n in order}
    dist[0][0] = 0
    # deletions of ref tokens at start
    for j in range(1, R + 1):
        dist[0][j] = j
    for n in order:
        dn = dist[n]
        # deletions of ref tokens while sitting at node n
        for j in range(1, R + 1):
            if dn[j - 1] + 1 < dn[j]:
                dn[j] = dn[j - 1] + 1
        for ai in out[n]:
            a = lat.arcs[ai]
            w = lat.lemma_orths[a.lemma] if a.lemma >= 0 else ""
            if w and ignore(w):
                w = ""
            dt = dist[a.to_node]
            if not w:
                np.minimum(dt, dn, out=dt)
            else:
                # consume hyp word w: match/sub against ref[j] or insertion
                for j in range(R + 1):
                    if dn[j] >= INF:
                        continue
                    # insertion
                    if dn[j] + 1 < dt[j]:
                        dt[j] = dn[j] + 1
                    if j < R:
                        c = dn[j] + (ref[j] != w)
                        if c < dt[j + 1]:
                            dt[j + 1] = c
    best = INF
    for n in lat.final_scores:
        d = dist[n]
        for j in range(R + 1):
            c = d[j] + (R - j)  # remaining deletions
            best = min(best, c)
    return int(best), list(ref)
