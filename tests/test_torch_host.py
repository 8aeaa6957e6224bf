"""The port's own copies of the host modules (lexicon, allophones, HMM,
tying, ARPA n-gram LM, LM interface, XML input) behave like the
reference's: each case makes the same calls on both sides and compares
what comes back as plain data."""

import gzip
import importlib
import math

import numpy as np
import pytest

MODULES = ("corpus.lexicon", "models.allophone", "models.hmm", "models.tying",
           "models.lm.arpa", "models.lm.interface", "utils.xmlio")

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


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_module_matches_reference(case, tmp_path):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    want = CASES[case](_mods("rasr_tpu"), ref_dir)
    got = CASES[case](_mods("rasr_tpu_torch"), port_dir)
    assert got == want
