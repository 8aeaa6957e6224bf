"""Search-error / WER-parity battery: a synthetic LVCSR task hard
enough that pruning can actually fail.

The reference's search quality is validated on LVCSR corpora (SURVEY
§6 / BASELINE configs 4-5 "WER parity"); this environment has no
datasets (SURVEY evidence log), so this module builds a CONTROLLED
synthetic equivalent with the properties that make pruning fail on
real tasks:

* a >=1k-word lexicon with heavy prefix sharing (words = shared
  prefix pool x suffix pool) and homophone pairs (identical
  pronunciation, distinct LM tokens — only the LM disambiguates);
* a 4-gram LM trained on text sampled from a Markov chain over the
  vocabulary, so histories genuinely predict words;
* GMM emissions with controlled class separation/noise: features are
  drawn from the scorer's own class means + sigma*N(0,1), so acoustic
  confusability is a dial, not an accident.

Measurement: decode a planted corpus at a grid of pruning settings and
compare to (a) the planted truth (WER) and (b) a maximally wide
reference decode (search-error rate: fraction of utterances whose
best cost is worse than the reference's, and the mean score
degradation). ``examples/search_error_battery.py`` runs the full grid
and writes the table recorded in BASELINE.md; the in-suite regression
(tests/test_battery.py) pins the production operating point.

The port's copy of ``rasr_tpu/pipeline/battery.py`` over the port's
modules, with the same seeds and the same order of draws: the task's
lexicon, LM text, model and planted corpus are the reference's. The
planted features are scored by the port's GMM scorer on ``device`` (the
card when None) and the decoders run on the device the caller names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..corpus.lexicon import Lexicon, build_default_silence
from ..lattice.evaluator import EditStats, align_tokens
from ..models.gmm import MixtureSet
from ..models.hmm import HmmTopology, TransitionModel
from ..models.lm.arpa import NgramLm
from ..models.lm.ngram import NgramTables, compile_ngram
from ..models.scorer import GmmFeatureScorer
from ..models.tying import MonophoneStateTying
from ..search.decoder import BeamConfig, TreeDecoder
from ..search.lookahead import BigramLookahead, build_bigram_lookahead
from ..search.tree import PrefixTree, build_prefix_tree


@dataclasses.dataclass
class BatteryTask:
    lexicon: Lexicon
    tying: MonophoneStateTying
    topology: HmmTopology
    transitions: TransitionModel
    lm: NgramLm
    tables: NgramTables
    tree: PrefixTree
    bigram_la: Optional[BigramLookahead]
    scorer: GmmFeatureScorer
    #: planted corpus: emissions [B, T, M], frame counts [B], and the
    #: reference orth token sequence per utterance
    emissions: np.ndarray
    n_frames: np.ndarray
    refs: List[List[str]]
    #: the LM training text (for building alternate-order n-grams or a
    #: fused RNN LM over the same source; examples/rnn_fusion_battery.py)
    train_text: Optional[List[List[str]]] = None

    def decoder(self, cfg: BeamConfig, bigram: bool = False, device=None) -> TreeDecoder:
        """The task's decoder under ``cfg`` on ``device`` (the card when
        None), with the task's bigram lookahead when ``bigram``."""
        return TreeDecoder(
            self.tree, self.tables, cfg,
            bigram_la=self.bigram_la if bigram else None,
            device=device,
        )


def _make_lexicon(
    rng, num_words: int, num_phones: int, homophone_frac: float
) -> Lexicon:
    """Prefix-shared lexicon: prons = (shared prefix) + (suffix), so the
    tree packs many words behind few first arcs — exactly the shape that
    makes early pruning decisions matter. A homophone twin shares its
    source's pronunciation exactly (acoustics cannot separate them)."""
    lex = Lexicon()
    build_default_silence(lex)
    phones = [f"p{i}" for i in range(num_phones)]
    for p in phones:
        lex.phonemes.add(p)
    n_prefix = max(num_words // 25, 4)
    prefixes = []
    seen_p = set()
    while len(prefixes) < n_prefix:
        pref = tuple(rng.choice(phones, size=int(rng.integers(2, 4))))
        if pref not in seen_p:
            seen_p.add(pref)
            prefixes.append(pref)
    prons: List[Tuple[str, ...]] = []
    seen = set()
    while len(prons) < num_words:
        pron = tuple(prefixes[int(rng.integers(n_prefix))]) + tuple(
            rng.choice(phones, size=int(rng.integers(1, 5)))
        )
        if pron not in seen:
            seen.add(pron)
            prons.append(pron)
    n_homo = int(num_words * homophone_frac)
    for w, pron in enumerate(prons):
        lex.add_lemma([f"w{w}"], [(list(pron), 0.0)])
    for h in range(n_homo):
        src = int(rng.integers(num_words))
        lex.add_lemma([f"h{h}"], [(list(prons[src]), 0.0)])
    return lex


def _markov_text(
    rng, words: List[str], n_sentences: int, support: int = 12,
    order: int = 1,
) -> List[List[str]]:
    """Sentences from a sparse Markov chain: each history has
    ``support`` successors with Dirichlet weights — histories genuinely
    predict words, so the n-gram LM (and its lookahead) has teeth.

    ``order=1`` (default): successors keyed on the previous word (the
    historical battery source — note a BIGRAM LM captures it exactly).
    ``order=2``: successors keyed on the previous TWO words (lazily
    materialized), so LM order genuinely matters — the source for
    truncated-recombination studies (RNN fusion, trigram lookahead)."""
    V = len(words)
    if order <= 1:
        # HISTORICAL path — the rng draw order here is part of every
        # pinned battery task's identity; do not touch
        succ = {w: rng.choice(V, size=support, replace=False) for w in range(V)}
        sprob = {
            w: rng.dirichlet(np.full(support, 0.3)).astype(np.float64)
            for w in range(V)
        }
        sents = []
        for _ in range(n_sentences):
            w = int(rng.integers(V))
            sent = [words[w]]
            for _ in range(int(rng.integers(3, 8))):
                w = int(rng.choice(succ[w], p=sprob[w]))
                sent.append(words[w])
            sents.append(sent)
        return sents

    cache: Dict[Tuple[int, int], Tuple] = {}

    def succ_of(key):
        e = cache.get(key)
        if e is None:
            # deterministic per-history sub-rng: lazily materialized
            # order-2 histories stay consistent across samples
            sub = np.random.default_rng((key[0] + 1) * 1000003 + key[1])
            e = (
                sub.choice(V, size=support, replace=False),
                sub.dirichlet(np.full(support, 0.3)).astype(np.float64),
            )
            cache[key] = e
        return e

    sents = []
    for _ in range(n_sentences):
        w = int(rng.integers(V))
        sent = [words[w]]
        prev2 = -1
        for _ in range(int(rng.integers(3, 8))):
            cand, p = succ_of((prev2, w))
            prev2 = w
            w = int(rng.choice(cand, p=p))
            sent.append(words[w])
        sents.append(sent)
    return sents


class GroupedContextTying:
    """Context-grouped triphone tying for the ACROSS-WORD battery:
    (center, left-group, right-group, boundary, hmm-state) — the CART
    shape at controlled resolution, so word-boundary contexts actually
    change acoustics and the across-word network has bite (same design
    as the crossword exactness fuzz's random tying)."""

    def __init__(self, rng, num_phones: int, groups: int = 3):
        self.table: Dict[Tuple, int] = {}
        self.lgroup = {0: 0}
        self.rgroup = {0: 0}
        for p in range(1, num_phones + 2):
            self.lgroup[p] = 1 + int(rng.integers(groups))
            self.rgroup[p] = 1 + int(rng.integers(groups))

    def classify(self, state) -> int:
        a = state.allophone
        key = (
            a.center, self.lgroup.get(a.left, 0),
            self.rgroup.get(a.right, 0), a.boundary, state.state,
        )
        return self.table.setdefault(key, len(self.table))

    @property
    def num_classes(self) -> int:
        return len(self.table)


def build_battery_task(
    num_words: int = 1000,
    num_phones: int = 25,
    lm_order: int = 4,
    homophone_frac: float = 0.05,
    noise: float = 1.0,
    separation: float = 1.6,
    feat_dim: int = 16,
    num_utts: int = 48,
    n_train_sentences: int = 20000,
    seed: int = 0,
    lookahead_classes: int = 64,
    lookahead_order: int = 2,
    lookahead_smooth: float = 0.0,
    markov_support: int = 12,
    markov_order: int = 1,
    across_word: bool = False,
    context_groups: int = 3,
    device=None,
) -> BatteryTask:
    """Build the task + a planted test corpus.

    ``separation``/``noise`` control acoustic difficulty: class means
    are N(0, separation^2) in feat_dim dims; observed features are the
    planted class mean + noise*N(0,1). At the defaults, adjacent-class
    emission costs overlap enough that the acoustics alone cannot pick
    the word — the LM must, which is what stresses pruning.

    ``across_word=True``: context-grouped triphone tying + the
    across-word search network; planted state sequences come from the
    TRUE cross-word alignment graphs (align/graph.py across_word), so
    word-boundary acoustics depend on the neighbors and the grouped
    roots / word-end fan / (r3) across-word bigram lookahead all carry
    real search load."""
    rng = np.random.default_rng(seed)
    lex = _make_lexicon(rng, num_words, num_phones, homophone_frac)
    topology = HmmTopology(states_per_phone=3, silence_states=1)
    if across_word:
        tying = GroupedContextTying(rng, len(lex.phonemes), context_groups)
    else:
        tying = MonophoneStateTying(lex, topology)
    transitions = TransitionModel()

    word_lemmas = [l for l in lex.lemmata if not l.special]
    word_orths = [l.primary_orth for l in word_lemmas]
    text = _markov_text(
        rng, word_orths, n_train_sentences, markov_support, markov_order
    )
    lm = NgramLm.train_from_text(text, order=lm_order)
    tables = compile_ngram(lm)
    unigrams = {wid: lm.score((), wid) for wid in lm.vocab.values()}
    tree = build_prefix_tree(
        lex, tying, topology, transitions, lm_vocab=lm.vocab,
        lm_unigrams=unigrams, across_word=across_word,
    )
    bla = build_bigram_lookahead(
        tree, lm, num_classes=lookahead_classes, order=lookahead_order,
        smooth=lookahead_smooth,
    )

    def make_gmm():
        M = tying.num_classes
        means = (
            separation * rng.normal(size=(M, 1, feat_dim))
        ).astype(np.float32)
        ms = MixtureSet(
            means=means,
            variances=np.ones((M, 1, feat_dim), np.float32),
            weights=np.ones((M, 1), np.float32),
            num_densities=np.ones(M, np.int32),
        )
        return means, GmmFeatureScorer(ms, scale=1.0, device=device)

    if not across_word:
        # rng draw ORDER is part of the task identity: the within-word
        # battery draws means BEFORE the test corpus (pinned regression
        # numbers depend on it); the across-word variant must draw them
        # AFTER planting because the interning context tying grows
        # until every planted alignment graph has been classified
        means, scorer = make_gmm()

    # ---- planted test corpus (same Markov chain as the LM training) --
    test_sents = _markov_text(
        rng, word_orths, num_utts, markov_support, markov_order
    )
    lemma_of = {l.primary_orth: l for l in word_lemmas}
    sil_states = topology.silence_states

    from ..models.allophone import Allophone, AllophoneState

    def states_of(lemma) -> List[int]:
        out = []
        for pid in lemma.pronunciations[0].phonemes:
            ph = lex.phonemes.by_id(pid)
            n = topology.num_states(ph.context_independent)
            for st in range(n):
                out.append(
                    tying.classify(AllophoneState(Allophone(pid), st))
                )
        return out

    sil_lemma = next(l for l in lex.lemmata if l.special == "silence")

    seqs: List[List[int]] = []
    refs: List[List[str]] = []
    if across_word:
        # planted chains from the TRUE cross-word alignment graphs
        from ..align.graph import build_linear_graph

        sil_orth = sil_lemma.primary_orth
        for sent in test_sents:
            toks = [sil_orth]
            for w in sent:
                toks.append(w)
                if rng.uniform() < 0.2:
                    toks.append(sil_orth)
            toks.append(sil_orth)
            g = build_linear_graph(
                " ".join(toks), lex, tying, topology, transitions,
                optional_silence=False, across_word=True,
            )
            seq: List[int] = []
            for c in g.emission_ids:
                for _ in range(1 + int(rng.integers(0, 3))):
                    seq.append(int(c))
            seqs.append(seq)
            refs.append(sent)
    else:
        sil_cls = states_of(sil_lemma)
        for sent in test_sents:
            seq: List[int] = list(sil_cls) * int(rng.integers(1, 3))
            for w in sent:
                for c in states_of(lemma_of[w]):
                    # 1-3 frames per state (geometric-ish durations)
                    for _ in range(1 + int(rng.integers(0, 3))):
                        seq.append(c)
                if rng.uniform() < 0.2:
                    seq.extend(sil_cls * int(rng.integers(1, 3)))
            seq.extend(sil_cls)
            seqs.append(seq)
            refs.append(sent)

    if across_word:
        means, scorer = make_gmm()

    T = max(len(s) for s in seqs)
    feats = np.zeros((num_utts, T, feat_dim), np.float32)
    n_frames = np.zeros(num_utts, np.int32)
    for b, seq in enumerate(seqs):
        n_frames[b] = len(seq)
        feats[b, : len(seq)] = means[np.asarray(seq), 0] + (
            noise * rng.normal(size=(len(seq), feat_dim))
        ).astype(np.float32)
    emissions = scorer(feats).cpu().numpy()

    return BatteryTask(
        lexicon=lex, tying=tying, topology=topology,
        transitions=transitions, lm=lm, tables=tables, tree=tree,
        bigram_la=bla, scorer=scorer, emissions=emissions,
        n_frames=n_frames, refs=refs, train_text=text,
    )


def run_operating_point(
    task: BatteryTask,
    cfg: BeamConfig,
    bigram: bool = False,
    ref_scores: Optional[np.ndarray] = None,
    batch: int = 0,
    device=None,
) -> Dict[str, float]:
    """Decode the task corpus at one pruning setting.

    Returns WER vs the planted truth plus — when ``ref_scores`` (the
    wide reference decode's best costs) is given — the search-error
    rate and mean score degradation vs that reference."""
    dec = task.decoder(cfg, bigram=bigram, device=device)
    B = task.emissions.shape[0]
    batch = batch or B
    stats = EditStats()
    scores = np.zeros(B, np.float64)
    utt_errs = np.zeros(B, np.int64)
    utt_ref = np.zeros(B, np.int64)
    for lo in range(0, B, batch):
        hi = min(lo + batch, B)
        results = dec.decode_scores(
            task.emissions[lo:hi], task.n_frames[lo:hi]
        )
        for i, res in enumerate(results):
            b = lo + i
            scores[b] = res.score
            st, _ = align_tokens(task.refs[b], res.words)
            stats.add(st)
            utt_errs[b] = st.errors
            utt_ref[b] = st.reference_length
    out = {"wer": stats.wer, "errors": float(stats.errors),
           "ref_len": float(stats.reference_length),
           "mean_score": float(scores.mean())}
    if ref_scores is not None:
        worse = scores > ref_scores + 1e-3
        out["search_error_rate"] = float(worse.mean())
        out["mean_degradation"] = float(
            np.maximum(scores - ref_scores, 0.0).mean()
        )
    out["_scores"] = scores  # type: ignore[assignment]
    # per-utterance stats for paired bootstrap CIs on WER deltas
    out["_utt_errors"] = utt_errs  # type: ignore[assignment]
    out["_utt_ref_len"] = utt_ref  # type: ignore[assignment]
    return out


def paired_bootstrap_delta(
    a: Dict, b: Dict, n_boot: int = 10000, seed: int = 0
) -> Dict[str, float]:
    """Paired utterance-level bootstrap of the WER delta (b - a).

    Resamples utterances with replacement and recomputes both systems'
    WER on the same sample — the standard paired test for recognition
    results (utterance errors are correlated within an utterance, so a
    word-level binomial overstates confidence). Returns the delta, its
    95% interval, and P(b < a)."""
    rng = np.random.default_rng(seed)
    ea, eb = a["_utt_errors"], b["_utt_errors"]
    ra, rb = a["_utt_ref_len"], b["_utt_ref_len"]
    B = ea.shape[0]
    idx = rng.integers(0, B, size=(n_boot, B))
    wa = ea[idx].sum(axis=1) / np.maximum(ra[idx].sum(axis=1), 1)
    wb = eb[idx].sum(axis=1) / np.maximum(rb[idx].sum(axis=1), 1)
    d = wb - wa
    return {
        "delta": float(eb.sum() / max(rb.sum(), 1) - ea.sum() / max(ra.sum(), 1)),
        "ci_lo": float(np.quantile(d, 0.025)),
        "ci_hi": float(np.quantile(d, 0.975)),
        "p_better": float((d < 0).mean()),
    }
