"""The port's own copies of the host modules (lexicon, allophones, HMM,
tying, ARPA n-gram LM, LM interface, XML input, statistics, logging,
cache archives, audio input, Bliss corpora) behave like the reference's:
each case makes the same calls on both sides and compares what comes
back as plain data."""

import gzip
import importlib
import json
import math
import os

import numpy as np
import pytest

MODULES = ("corpus.lexicon", "models.allophone", "models.hmm", "models.tying",
           "models.lm.arpa", "models.lm.interface", "utils.xmlio", "utils.statistics",
           "utils.logging", "utils.archive", "corpus.audio", "corpus.bliss")

LEXICON_XML = """<?xml version="1.0" encoding="utf-8"?>
<lexicon>
  <phoneme-inventory>
    <phoneme><symbol>si</symbol><variation>none</variation></phoneme>
    <phoneme><symbol>a</symbol></phoneme>
    <phoneme><symbol>b</symbol></phoneme>
    <phoneme><symbol>c</symbol></phoneme>
  </phoneme-inventory>
  <lemma special="silence"><orth>[SILENCE]</orth><phon>si</phon><synt/><eval/></lemma>
  <lemma><orth>AB</orth><orth>A  B</orth><phon score="0.5">a b</phon><phon>a b c</phon></lemma>
  <lemma><orth>CAB</orth><phon>c a b</phon><synt><tok>CAB</tok><tok>X</tok></synt></lemma>
  <lemma special="unknown"><orth>[UNK]</orth><eval>u n k</eval></lemma>
</lexicon>
"""

SENTENCES = [["AB", "BA", "AB"], ["ABC", "C", "AA"], ["BAB", "AB", "C"], ["AB", "C"]]


def _mods(root):
    return {name: importlib.import_module(f"{root}.{name}") for name in MODULES}


def _lexicon_data(lex):
    return (
        [(p.symbol, p.id, p.context_independent) for p in lex.phonemes],
        [(l.id, l.orth, [(p.phonemes, p.score) for p in l.pronunciations], l.special,
          l.synt_tokens(), l.eval_tokens()) for l in lex.lemmata],
        lex.num_pronunciations(), lex.silence.id, getattr(lex.unknown, "id", None),
        [l.id for l in lex.lookup_orth("AB")],
        [l.id for l in lex.words_with_pronunciations()],
    )


def _lexicon(m):
    lex = m["corpus.lexicon"].Lexicon()
    m["corpus.lexicon"].build_default_silence(lex)
    for orth, pron in (("AB", "a b"), ("BA", "b a"), ("AB", "a b c"), ("C", "c")):
        lex.add_lemma([orth], [(pron.split(), 0.25 * len(pron))])
    return lex


def _all_states(m, lex, topo):
    alpha = m["models.allophone"].AllophoneAlphabet(lex, max_states=3)
    out = []
    for lemma in lex.words_with_pronunciations():
        for pron in lemma.pronunciations:
            out += alpha.phone_sequence_states(pron.phonemes, topo)
            for left in range(len(lex.phonemes)):
                out += alpha.phone_states(pron.phonemes[0], left, pron.phonemes[-1], topo, 1)
    return alpha, out


def case_lexicon_from_lemmas(m, tmp_path):
    return _lexicon_data(_lexicon(m))


def case_lexicon_from_xml(m, tmp_path):
    plain, packed = tmp_path / "lex.xml", tmp_path / "lex.xml.gz"
    plain.write_text(LEXICON_XML)
    packed.write_bytes(gzip.compress(LEXICON_XML.encode()))
    Lexicon = m["corpus.lexicon"].Lexicon
    root = m["utils.xmlio"].parse_xml(str(packed)).getroot()
    return (_lexicon_data(Lexicon.load(str(plain))), _lexicon_data(Lexicon.load(str(packed))),
            [e.tag for e in root.iter()])


def case_allophones(m, tmp_path):
    lex = _lexicon(m)
    topo = m["models.hmm"].HmmTopology(states_per_phone=3, silence_states=1)
    alpha, states = _all_states(m, lex, topo)
    ids = [alpha.index(s) for s in states]
    unpacked = [alpha.unpack(i) for i in ids]
    return (ids, [(u.allophone.center, u.allophone.left, u.allophone.right,
                   u.allophone.boundary, u.state) for u in unpacked],
            [s.format(lex) for s in states], alpha.size_bound)


def case_tying(m, tmp_path):
    lex = _lexicon(m)
    hmm, tying = m["models.hmm"], m["models.tying"]
    out = []
    for spp, reps in ((3, 1), (1, 1), (2, 2)):
        topo = hmm.HmmTopology(states_per_phone=spp, silence_states=1, state_repetitions=reps)
        mono = tying.MonophoneStateTying(lex, topo)
        alpha, states = _all_states(m, lex, topo)
        lut = tying.LutStateTying(alpha, {alpha.index(s): (7 * i) % 5 for i, s in
                                          enumerate(states)})
        path = tmp_path / f"lut{spp}{reps}.json"
        lut.save(str(path))
        back = tying.LutStateTying.load(alpha, str(path))
        out.append((mono.num_classes, [mono.classify(s) for s in states], lut.num_classes,
                    [back.classify(s) for s in states], topo.num_states(True),
                    topo.num_states(False), [topo.emitting_state_index(p) for p in range(6)]))
    return out


def case_transition_model(m, tmp_path):
    hmm = m["models.hmm"]
    models = (hmm.TransitionModel(),
              hmm.TransitionModel(speech=hmm.Tdp(loop=1.0, forward=0.0, skip=2.0, exit=0.5),
                                  silence=hmm.Tdp(loop=0.2, forward=0.5, skip=math.inf,
                                                  exit=0.3)))
    return [(t.for_class(False).as_tuple(), t.for_class(True).as_tuple()) for t in models]


def case_ngram_scores(m, tmp_path):
    out = []
    for order in (1, 2, 3):
        lm = m["models.lm.arpa"].NgramLm.train_from_text(SENTENCES, order=order)
        words = sorted(lm.vocab.values())
        h, scores = lm.start_history(), []
        for w in [lm.vocab[t] for t in ("AB", "C", "AA", "BA", "AB")]:
            scores.append([lm.score(h, v) for v in words])
            h = lm.extended_history(h, w)
        out.append((lm.order, lm.vocab, scores, lm.sentence_end_score(h),
                    lm.sequence_score(["AB", "C", "BAB"]), lm.perplexity(["AB", "C"])))
    return out


def case_arpa_round_trip(m, tmp_path):
    NgramLm = m["models.lm.arpa"].NgramLm
    lm = NgramLm.train_from_text(SENTENCES, order=3)
    path = tmp_path / "lm.arpa"
    lm.write_arpa(str(path))
    back = NgramLm.read_arpa(str(path))
    grams = {g: tuple(np.float32(v) for v in e) for g, e in back.ngrams.items()}
    return path.read_text(), back.order, back.vocab, grams


def case_lm_interface(m, tmp_path):
    iface = m["models.lm.interface"]
    lm = m["models.lm.arpa"].NgramLm.train_from_text(SENTENCES, order=2)
    zero = iface.Zerogram(lm.vocab)
    both = iface.CombineLanguageModel([lm, zero], [0.7, 0.3])
    scaled = iface.ScaledLanguageModel(lm, 2.5)
    cls = iface.ClassLanguageModel(lm, {w: w % 3 for w in lm.vocab.values()}, {2: 0.25},
                                   lm.vocab)
    toks = ["AB", "C", "AA"]
    return [(x.sequence_score(toks), x.perplexity(toks)) for x in (zero, both, scaled)] + [
        cls.score(cls.start_history(), lm.vocab["C"])]


def case_statistics(m, tmp_path):
    st = m["utils.statistics"]
    rng = np.random.default_rng(5)
    a, b = st.Accumulator("a"), st.Accumulator("b")
    for v in rng.normal(size=20):
        a += float(v)
    for v in rng.uniform(size=7):
        b.add(float(v), weight=2.0)
    empty = st.Accumulator().report()
    a.merge(b)
    h = st.Histogram(-1.0, 1.0, bins=8, name="h")
    for v in rng.normal(size=50):
        h.add(float(v))
    reg = st.StatisticsRegistry()
    reg.accumulator("x").add(3.0)
    reg.accumulator("x").add(5.0)
    reg.histogram("y", 0.0, 10.0, 4).add(7.5)
    with st.Timer() as timer:
        pass
    return (a.report(), a.variance, empty, h.report(), [h.quantile(q) for q in (0.1, 0.5, 0.9)],
            st.Histogram(0.0, 1.0).quantile(0.5), reg.report(), timer.elapsed >= 0.0)


def case_logging(m, tmp_path):
    lg = m["utils.logging"]
    mgr = lg.LogManager()
    path = tmp_path / "logs" / "run.jsonl"
    mgr.open_jsonl(str(path))
    stats = mgr.channel("recognizer", "statistics")
    stats("recognized", segment="c/r/s", score=1.5, words=["A", "B"])
    mgr.channel("recognizer", "log")("corpus done", wer=0.25)
    with mgr.channel("trainer", "log").timed("epoch"):
        pass
    mgr.channel("x", "warning")()
    mgr._jsonl.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    for r in recs:
        assert r.pop("t") >= 0 and r.pop("elapsed_s", 0.0) >= 0
    return recs, stats.component, stats.kind


def case_archive(m, tmp_path):
    ar = m["utils.archive"]
    rng = np.random.default_rng(9)
    arrays = [rng.normal(size=(4, 3)).astype(np.float32), np.arange(10, dtype=np.int64),
              rng.integers(0, 255, size=(2, 2, 2)).astype(np.uint8)]
    p1, p2 = str(tmp_path / "one.cache"), str(tmp_path / "two.cache")
    with ar.FileArchive(p1, "w") as a:
        a.write("x", b"first")
        a.write("big", b"ab" * 500)  # compressed
        a.write("x", b"second")  # overwrite
        a.write("gone", b"...")
        a.delete("gone")
        for i, x in enumerate(arrays):
            a.write(f"arr{i}", ar.pack_ndarray(x))
    with ar.FileArchive(p1, "r") as a:  # through the index sidecar
        first = (sorted(a.keys()), a.read("x"), a.read("big"), "gone" in a,
                 [ar.unpack_ndarray(a.read(f"arr{i}")).tolist() for i in range(3)])
    os.remove(p1 + ".idx")
    with ar.FileArchive(p1, "a") as a:  # rescanned, then appended to
        rescanned = sorted(a.keys())
        a.write("late", b"z")
    with ar.FileArchive(p2, "w", compress=False) as a:
        a.write("x", b"shadowed")
        a.write("only2", b"ab" * 500)
    bundle = tmp_path / "all.bundle"
    bundle.write_text("# members\none.cache\n\n" + p2 + "\n")
    b = ar.open_archive(str(bundle))
    merged = (b.keys(), b.read("x"), b.read("only2"), "late" in b, "nope" in b)
    b.close()
    with open(p1, "rb") as fh, open(p2, "rb") as fh2:
        images = (fh.read(), fh2.read())
    return first, rescanned, merged, images


def case_audio(m, tmp_path):
    au = m["corpus.audio"]
    rng = np.random.default_rng(2)
    mono = (rng.normal(size=3000) * 0.3).astype(np.float32)
    stereo = (rng.normal(size=(1000, 2)) * 0.3).astype(np.float32)
    au.write_wav(str(tmp_path / "m.wav"), mono, 8000)
    au.write_wav(str(tmp_path / "s.wav"), stereo)
    (tmp_path / "r.raw").write_bytes((mono * 20000).astype("<i2").tobytes())
    out = []
    for name in ("m.wav", "s.wav", "r.raw"):
        a = au.read_audio(str(tmp_path / name))
        out.append((a.samples.tolist(), a.sample_rate, a.duration))
        out.append(au.extract_segment(a, 0.01, 0.05, track=a.samples.ndim - 1).tolist())
        out.append(au.extract_segment(a, 0.02, float("inf")).shape)
    try:
        au.read_audio(str(tmp_path / "x.flac"))
    except (ValueError, OSError, RuntimeError) as exc:
        out.append(type(exc).__name__)
    return out


CORPUS_XML = """<?xml version="1.0" encoding="utf-8"?>
<corpus name="c">
  <speaker-description name="s1"><gender>female</gender><age>40</age></speaker-description>
  <recording name="r0" audio="r0.wav">
    <segment name="a" start="0.5" end="2.0" track="1"><speaker name="s1"/>
      <orth>  HELLO   WORLD </orth><condition name="quiet"/></segment>
    <segment end="3.5"><orth>AGAIN</orth></segment>
  </recording>
  <subcorpus name="sub">
    <include file="more.corpus"/>
    <recording name="r1" audio="/abs/r1.wav"><segment name="b" start="1" end="2"/></recording>
  </subcorpus>
</corpus>
"""

MORE_XML = """<corpus name="more">
  <recording name="r2" audio="r2.wav"><segment name="c"><orth>X Y</orth></segment>
    <segment name="d" start="4" end="6"/></recording>
</corpus>
"""


def case_bliss(m, tmp_path):
    bliss = m["corpus.bliss"]
    (tmp_path / "c.corpus.gz").write_bytes(gzip.compress(CORPUS_XML.encode()))
    (tmp_path / "more.corpus").write_text(MORE_XML)
    corpus = bliss.CorpusDescription.load(str(tmp_path / "c.corpus.gz"), audio_dir="audio")

    def segs(*args):
        return [(s.name, s.full_name, s.recording.full_name, s.recording.audio, s.start, s.end,
                 s.track, s.orth, s.speaker, s.condition, s.duration)
                for s in corpus.segments(*args)]

    return (corpus.name, [(k, v.gender, v.attributes) for k, v in corpus.speakers.items()],
            segs(), segs(0, 2), segs(1, 2), segs(2, 3), segs(0, 1, ["c/r0/a", "b", "nope"]),
            corpus.statistics())


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_module_matches_reference(case, tmp_path):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    want = CASES[case](_mods("rasr_tpu"), ref_dir)
    got = CASES[case](_mods("rasr_tpu_torch"), port_dir)
    assert got == want


def test_log_managers_are_separate(tmp_path):
    """The port's process-wide log manager is its own: a sink opened on it
    leaves the reference's untouched, and the reverse."""
    ours, theirs = (importlib.import_module(f"{r}.utils.logging").LogManager
                    for r in ("rasr_tpu_torch", "rasr_tpu"))
    assert ours.get() is ours.get() and ours.get() is not theirs.get()
    saved = ours.get()._jsonl, theirs.get()._jsonl
    try:
        ours.get().open_jsonl(str(tmp_path / "port.jsonl"))
        ours.get().channel("c", "statistics")("port only")
        theirs.get()._jsonl = None
        theirs.get().channel("c", "statistics")("reference only")
        ours.get()._jsonl.close()
        assert [json.loads(line)["msg"] for line in
                (tmp_path / "port.jsonl").read_text().splitlines()] == ["port only"]
    finally:
        ours.get()._jsonl, theirs.get()._jsonl = saved
