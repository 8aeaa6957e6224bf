"""The port's span recorder (``rasr_tpu_torch/utils/profiling.py``): spans
and their nesting, the bound per name, the accumulators, the Chrome
export, the clock against ``torch.profiler``'s; the spans the layers
record; the decoder's phase marks, made only by ``profile_decode``'s eager
step and changing nothing the decode returns; and the benchmark's readers
of the spans."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import spec
from rasr_tpu_torch import synthetic
from rasr_tpu_torch.align import aligner as tal
from rasr_tpu_torch.align import graph as tgr
from rasr_tpu_torch.corpus import lexicon as tlex
from rasr_tpu_torch.models import gmm as tgmm
from rasr_tpu_torch.models import hmm as thmm
from rasr_tpu_torch.models import scorer as tscorer
from rasr_tpu_torch.models import tying as ttying
from rasr_tpu_torch.search import decoder as tdec
from rasr_tpu_torch.utils import profiling


@pytest.fixture
def recorder(monkeypatch):
    """A fresh process recorder for the test."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def test_spans_nest_with_parent_call_and_counts():
    rec = profiling.Recorder()
    with rec.span("outer", utterances=2) as outer:
        with rec.span("inner", chunks=3) as inner:
            pass
        with rec.span("inner"):
            pass
    with rec.span("outer") as again:
        pass
    assert (outer.parent, outer.call) == (None, outer.id)
    assert (inner.parent, inner.call) == (outer.id, outer.id)
    assert again.call == again.id != outer.call
    assert outer.counts == {"utterances": 2} and inner.counts == {"chunks": 3}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert [sp.id for sp in rec.records("outer")] == [outer.id, again.id]
    assert len(rec.records("inner")) == 2 and rec.records("missing") == []
    assert not outer.profiled
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("traced") as traced:
            pass
    assert traced.profiled


def test_bound_per_name_and_accumulators():
    rec = profiling.Recorder(bound=3)
    for _ in range(5):
        with rec.span("a"):
            time.sleep(1e-4)
    with rec.span("b"):
        pass
    kept = rec.records("a")
    assert len(kept) == 3 and kept[0].id == 3  # the oldest two went
    report = rec.report()
    assert sorted(report) == ["a", "b"]
    assert report["a"]["n"] == 5 and report["b"]["n"] == 1  # every span counted
    assert report["a"]["min"] >= 100.0  # microseconds
    assert report["a"]["sum"] == pytest.approx(
        report["a"]["mean"] * 5) and report["a"]["max"] >= report["a"]["min"]
    assert rec.records("c") == []


def test_marked_phases_become_steps_with_children():
    rec = profiling.Recorder()
    stamps = [1000 + 10 * i for i in range(1 + 3 * 4)] + [5000]  # 4 passes of 3 and a partial
    with rec.span("dispatch") as d:
        rec.add_marked("step", ("x", "y", "z"), stamps)
    steps = rec.records("step")
    assert len(steps) == 4 and [len(rec.records(f"step.{p}")) for p in "xyz"] == [4, 4, 4]
    off = rec.offset_ns
    assert [(sp.start_ns - off, sp.end_ns - off) for sp in steps] == [
        (1000 + 30 * k, 1030 + 30 * k) for k in range(4)]
    for p, child in zip("xyz", (rec.records(f"step.{p}")[1] for p in "xyz")):
        assert child.parent == steps[1].id and child.call == d.call
        assert child.end_ns - child.start_ns == 10
    assert all(sp.parent == d.id for sp in steps)
    assert rec.report()["step.x"]["n"] == 4


def test_export_chrome_is_valid_json_on_the_base(tmp_path):
    rec = profiling.Recorder()
    with rec.span("outer", frames=7):
        with rec.span("inner"):
            pass
    base = rec.records("outer")[0].start_ns - 5000
    n = rec.export_chrome(str(tmp_path / "spans.json"), base)
    doc = json.loads((tmp_path / "spans.json").read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert n == 2 and [e["name"] for e in xs] == ["outer", "inner"]
    assert xs[0]["ts"] == pytest.approx(5.0) and xs[0]["dur"] >= xs[1]["dur"] >= 0
    assert xs[0]["args"]["frames"] == 7 and xs[1]["args"]["parent"] == xs[0]["args"]["id"]
    assert doc["baseTimeNanoseconds"] == base
    assert rec.export_chrome(str(tmp_path / "none.json"), since_ns=rec.now_ns() + 10**9) == 0


def test_trace_writes_spans_beside_the_profiler_trace(tmp_path, recorder):
    with profiling.trace(str(tmp_path)):
        with profiling.span("block", frames=2):
            torch.ones(8).sum()
    spans = json.loads((tmp_path / "spans.json").read_text())
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert spans["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    assert [e["name"] for e in spans["traceEvents"] if e["ph"] == "X"] == ["block"]
    merged = json.loads(open(profiling.merge_chrome(str(tmp_path))).read())
    names = {e.get("name") for e in merged["traceEvents"]}
    assert "block" in names and "aten::sum" in names


def test_spans_share_the_profilers_clock():
    rec = profiling.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        with rec.span("program") as sp:
            with record_function("marker"):
                torch.ones(4).sum()
    (marker,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "marker"]
    assert abs(marker.start_ns() - sp.start_ns) < 200_000


def test_spanned_decorator_spans_each_call(recorder):
    @profiling.spanned("layer.call")
    def call(x):
        assert [sp.name for sp in recorder._stack()] == ["layer.call"]
        return sum(x)

    assert call([1, 2, 3]) == 6 and call([4]) == 4
    assert len(profiling.records("layer.call")) == 2 and call.__name__ == "call"
    assert profiling.report()["layer.call"]["n"] == 2


# ---------------------------------------------------------- the layers
def _tiny_setup():
    beam = dataclasses.replace(synthetic.PRODUCTION_BEAM, max_hyps=32, root_hyps=4,
                               branch_hyps=8, word_end_limit=8, root_select=16, lm_scale=1.0)
    return synthetic.build_setup(num_words=30, num_classes=50, densities=2, device="cpu",
                                 beam=beam)


def _tiny_decode_inputs():
    g = torch.Generator().manual_seed(0)
    return torch.rand(2, 30, 50, generator=g) * 5, torch.tensor([30, 22])


def _decoded(decoder, handle):
    res = decoder.results_from_device(handle)
    return ([(r.words, r.word_ends, r.score, r.record_ids) for r in res],
            handle.records_to_host())


def _assert_same_decode(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1].records + got[1].finals, want[1].records + want[1].finals):
        np.testing.assert_array_equal(a, b)


def test_decoder_phase_marks_only_under_the_profiler(recorder):
    """The program's decode never marks phases, under the profiler or not
    (the profiler leaves the decode's path as it is); the marks come from
    ``profile_decode``'s eager step (the test below)."""
    s = _tiny_setup()
    em, nf = _tiny_decode_inputs()

    def decode():
        return _decoded(s.decoder, s.decoder.decode_scores_device(em, nf))

    plain = decode()
    assert recorder.records("decode.step") == []
    (dispatch,) = recorder.records("decode.dispatch")
    assert dispatch.counts == {"steps": 30, "graph_steps": 0} and not dispatch.profiled
    (read,) = recorder.records("decode.read")
    (wait,) = recorder.records("decode.read.wait")
    assert wait.parent == read.id and read.start_ns <= wait.start_ns <= wait.end_ns <= read.end_ns
    with profile(activities=[ProfilerActivity.CPU]):
        traced = decode()
    assert any(words for words, *_ in plain[0])
    _assert_same_decode(traced, plain)
    assert recorder.records("decode.step") == []
    assert recorder.records("decode.dispatch")[-1].profiled


def test_profile_decode_marks_phases_in_order(recorder):
    """``profile_decode.marked_decode``: the eager step's marks make one
    ``decode.step`` span a frame with a child per phase in ``PHASES``
    order, end to end, and the decode equals the program's."""
    from rasr_tpu_torch.examples import profile_decode

    s = _tiny_setup()
    em, nf = _tiny_decode_inputs()
    plain = _decoded(s.decoder, s.decoder.decode_scores_device(em, nf))
    marked = _decoded(s.decoder, profile_decode.marked_decode(s.decoder, em, nf))
    _assert_same_decode(marked, plain)
    steps = recorder.records("decode.step")
    assert len(steps) == 30 and all(sp.parent is None for sp in steps)
    for phase in tdec.PHASES:
        children = recorder.records(f"decode.step.{phase}")
        assert [c.parent for c in children] == [sp.id for sp in steps]
    assert len(tdec.PHASES) == 9
    for k, step in enumerate(steps):
        kids = [recorder.records(f"decode.step.{p}")[k] for p in tdec.PHASES]
        assert kids[0].start_ns == step.start_ns and kids[-1].end_ns == step.end_ns
        assert all(a.end_ns == b.start_ns for a, b in zip(kids, kids[1:]))
    assert all(a.end_ns == b.start_ns for a, b in zip(steps, steps[1:]))
    # the program's decode kept its step: the marked one was its own
    assert s.decoder._step().marks is None


def test_no_frame_step_replays_a_graph_on_the_cpu(recorder):
    """``graph_steps`` counts the frames replayed from a CUDA graph: none on
    the CPU, where the step runs eagerly (offline, streamed and marked)."""
    from rasr_tpu_torch.search.streaming import StreamingDecoder

    s = _tiny_setup()
    em, nf = _tiny_decode_inputs()
    s.decoder.decode_scores_device(em, nf)
    s.decoder.decode_scores_device(em[:, :20], nf.clamp(max=20))
    assert [sp.counts for sp in recorder.records("decode.dispatch")] == [
        {"steps": 30, "graph_steps": 0}, {"steps": 20, "graph_steps": 0}]
    sd = StreamingDecoder(s.decoder).restart(2, nf)
    sd.feed(em[:, :16])
    step = s.decoder._step()
    assert sd._step is step and step.graph_for(em) is None and step._graphs == {}
    assert recorder.records("decode.capture") == []


def _align_setup():
    lex = tlex.Lexicon()
    tlex.build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = thmm.HmmTopology(states_per_phone=2, silence_states=1)
    tying = ttying.MonophoneStateTying(lex, topo)
    rng = np.random.default_rng(0)
    means = rng.normal(size=(tying.num_classes, 4)).astype(np.float32)
    ms = tgmm.MixtureSet.single_density(means, np.ones_like(means))
    graphs = [tgr.build_linear_graph(o, lex, tying, topo) for o in ("AB", "BA AB")]
    feats = torch.from_numpy(rng.normal(size=(2, 12, 4)).astype(np.float32))
    return ms, graphs, feats


def test_aligner_and_graph_spans(recorder):
    ms, graphs, feats = _align_setup()
    assert len(recorder.records("align.graph")) == 2
    scorer = tscorer.GmmFeatureScorer(ms, device="cpu")
    tal.BatchAligner(scorer).align(feats, graphs, np.array([10, 12]))
    (top,) = recorder.records("align.viterbi")
    assert top.counts == {"frames": 12} and not top.profiled
    reads = recorder.records("align.read")
    assert len(reads) == 2 and all(sp.parent == top.id for sp in reads)
    assert all(top.start_ns <= sp.start_ns <= sp.end_ns <= top.end_ns for sp in reads)
    tal.BatchAligner(scorer, mode="baum-welch").align(feats, graphs, np.array([10, 12]))
    assert len(recorder.records("align.viterbi")) == 1 and len(recorder.records("align.read")) == 2


#: every span the port records, and what reads it: the benchmark's readers
#: (benchmark/metrics/) or examples/profile_decode.py
READ_SPANS = {"decode.dispatch", "decode.read", "decode.read.wait", "align.viterbi",
              "align.read", "align.graph", "decode.capture", "decode.step",
              *(f"decode.step.{p}" for p in tdec.PHASES), "zipformer.forward"}
#: the spans recorded on a card only (tests/test_torch_cuda.py)
CARD_SPANS = {"decode.capture"}


def test_every_recorded_span_has_a_reader(recorder):
    from rasr_tpu_torch.examples import profile_decode

    s = _tiny_setup()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 4000)).astype(np.float32))
    feats, nf = s.frontend(x, torch.tensor([4000, 3000]))
    with profile(activities=[ProfilerActivity.CPU]):
        handle = s.decoder.decode_scores_device(s.scorer(feats), nf)
        s.decoder.results_from_device(handle)
    profile_decode.marked_decode(s.decoder, s.scorer(feats)[:, :5], nf.clamp(max=5))
    ms, graphs, afeats = _align_setup()
    als = tal.BatchAligner(tscorer.GmmFeatureScorer(ms, device="cpu")).align(
        afeats, graphs, np.array([10, 12]))
    from rasr_tpu_torch.train import em

    labels = np.full((2, 12), -1, np.int32)
    for i, a in enumerate(als):
        labels[i, : a.num_frames] = a.emission_ids
    em.accumulate(em.GmmAccumulator.zeros(*ms.means.shape), ms, afeats, labels, device="cpu")
    from rasr_tpu_torch.models.zipformer import ZipformerEncoderNet

    ZipformerEncoderNet(5, 13, num_encoder_layers=(1,), downsampling_factor=(2,),
                        encoder_dim=(8,), feedforward_dim=(8,), num_heads=(1,),
                        cnn_module_kernel=(3,), query_head_dim=4, value_head_dim=2,
                        pos_head_dim=2, pos_dim=4, device="cpu")(torch.zeros(1, 8, 13))
    assert set(recorder.report()) == READ_SPANS - CARD_SPANS


def test_span_cost_on_a_tiny_setup(recorder):
    from rasr_tpu_torch.examples import span_cost

    recording = profiling.profiler_recording
    out = span_cost.run("cpu", decodes=2, profiled=1, profile_frames=10, setup=_tiny_setup(),
                        batch=2, frames=30)
    assert len(out["off"]["host_us_per_step"]["values"]) == 2
    assert len(out["off"]["dispatch_span_us_per_step"]["values"]) == 2
    assert len(out["off"]["read_wait_us"]["values"]) == 2
    assert len(out["on"]["values"]) == 1
    # the profiled decode runs the program's path: no phase marks
    assert recorder.records("decode.step") == []
    assert profiling.profiler_recording is recording
    assert all(v > 0 for v in out["off"]["host_us_per_step"]["values"])


# ------------------------------------------------- the benchmark's readers
READERS = ("decoder.host_us_per_step", "results.wait_share", "aligner.host_us_per_frame",
           "graphs.host_us_per_utterance", "decoder.graph_share")


def _plant(rec, name, us, profiled=False, parent=None, **counts):
    sp = profiling.Span(None, name, counts)
    sp.id, sp.parent, sp.profiled = next(rec._ids), parent, profiled
    sp.start_ns, sp.end_ns = 10**18, 10**18 + int(us * 1e3)
    rec._keep(sp)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_spans(name, recorder, monkeypatch):
    assert spec.reader(name)({}) is None
    _plant(recorder, "decode.dispatch", 1000.0, profiled=True, steps=10)
    _plant(recorder, "align.viterbi", 1000.0, profiled=True, frames=10)
    _plant(recorder, "align.graph", 1000.0, profiled=True)
    assert spec.reader(name)({}) is None  # only the profiled batch's
    monkeypatch.delattr(profiling, "records")  # a program without the recorder
    assert spec.reader(name)({}) is None


def test_readers_on_planted_spans(recorder):
    for us, steps in ((4000.0, 1000), (6000.0, 1000), (3000.0, 500)):
        _plant(recorder, "decode.dispatch", us, steps=steps, utterances=64)
        _plant(recorder, "decode.read", 50.0)
        _plant(recorder, "decode.read.wait", 20.0)
    _plant(recorder, "decode.dispatch", 99e6, profiled=True, steps=10)
    for us, read_us in ((150.0, 0.0), (250.0, 30e3), (200.0, 10e3)):
        _plant(recorder, "align.viterbi", us * 1000, frames=1000)
        if read_us:  # the reads inside it wait for the card: taken out
            parent = recorder.records("align.viterbi")[-1].id
            for _ in range(2):
                _plant(recorder, "align.read", read_us / 2, parent=parent)
    for us in (700.0, 900.0, 1200.0, 800.0):
        _plant(recorder, "align.graph", us)
    got = {name: spec.reader(name)({}) for name in READERS}
    assert got["decoder.host_us_per_step"] == pytest.approx(6.0)  # median of 4, 6, 6
    assert got["results.wait_share"] == pytest.approx(100 * 60 / (13000 + 150))
    assert got["aligner.host_us_per_frame"] == pytest.approx(190.0)  # of 150, 220, 190
    assert got["graphs.host_us_per_utterance"] == pytest.approx(850.0)


def test_graph_share_on_planted_spans(recorder):
    """``decoder.graph_share``: replayed frames over frames, summed over the
    unprofiled dispatch spans; spans without the count (a program without
    the graph) are not read."""
    read = spec.reader("decoder.graph_share")
    _plant(recorder, "decode.dispatch", 4000.0, steps=1000)
    assert read({}) is None
    for us, steps, graphed in ((4000.0, 300, 300), (2000.0, 1000, 1000), (3000.0, 700, 0)):
        _plant(recorder, "decode.dispatch", us, steps=steps, graph_steps=graphed)
    _plant(recorder, "decode.dispatch", 99e6, profiled=True, steps=10, graph_steps=0)
    assert read({}) == pytest.approx(100.0 * 1300 / 2000)
