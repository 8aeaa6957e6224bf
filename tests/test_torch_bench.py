"""The port's benchmark entry point, ``python -m rasr_tpu_torch.bench``.

``run(device="cpu")`` at a tiny size runs both canaries and prints one
JSON line of the stated shape (the port's own metric name, the per-window
rates, the device); ``main()`` reads bench.py's ``BENCH_*`` knobs and
raises without a card; a non-default ``BENCH_UNROLL`` raises. The
canaries hold: bench.py's planted decode on the CPU, and the
cross-device decode against a decoder whose scores are off. With
``train=True`` (``BENCH_TRAIN=1``) it times conformer training steps at a
tiny width and prints one ``torch_train_mfu`` line; its FLOP count is
held against ``torch.utils.flop_counter.FlopCounterMode``.
"""

import io
import itertools
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from rasr_tpu_torch import bench, synthetic
from rasr_tpu_torch.models.nn import ConformerEncoderNet
from rasr_tpu_torch.synthetic import CONFORMER
from rasr_tpu_torch.train.nn_trainer import SequenceTrainer, TrainConfig

TINY = dict(words=30, classes=50, batch=2, audio_s=1.0, iters=2, windows=3, max_hyps=32,
            word_end_limit=8, root_hyps=4, branch_hyps=8)


def test_run_prints_one_result_line():
    out = io.StringIO()
    record = bench.run(device="cpu", out=out, **TINY)
    (line,) = out.getvalue().splitlines()
    assert json.loads(line) == record
    assert record["metric"] == "torch_decode_throughput" != "decode_throughput"
    assert record["unit"] == "audio_seconds/s/chip" and "vs_baseline" not in record
    assert len(record["windows"]) == 3 and record["value"] == np.median(record["windows"]) > 0
    assert record["canaries"] == ["planted", "across-word", "4gram-two-key", "bigram-la",
                                  "branch-width+we-rank", "across-word+bigram-la"]
    assert record["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert record["card"] is None and record["batch"] == 2 and record["knobs"]["words"] == 30


def test_knobs_come_from_the_environment():
    env = {"BENCH_BATCH": "128", "BENCH_ACROSS": "1", "BENCH_DEFER": "0", "BENCH_LA_SMOOTH": "0.5",
           "BENCH_NET_CACHE": "/tmp/net.npz", "BENCH_SCORER": "conformer", "OTHER": "x"}
    assert bench.knobs_from_env(env) == dict(batch=128, across_word=True, deferred_emission=False,
                                             la_smooth=0.5, net_cache="/tmp/net.npz",
                                             scorer="conformer")
    assert bench.knobs_from_env({}) == {}


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in [v for v, *_ in bench.KNOBS.values()]:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()


@pytest.mark.parametrize("env", [{"BENCH_UNROLL": "4"}])
def test_unported_knobs_raise(monkeypatch, env):
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError):
        bench.run(device="cpu", **bench.knobs_from_env())
    with pytest.raises(TypeError, match="unknown"):
        bench.run(device="cpu", beams=3)


def test_net_cache_saves_then_loads_the_network(tmp_path, monkeypatch):
    """BENCH_NET_CACHE: the first run builds the network and saves its
    image, the next loads it and builds none."""
    path = str(tmp_path / "net.npz")
    knobs = dict(TINY, windows=1, net_cache=path)
    bench.run(device="cpu", out=io.StringIO(), **knobs)
    assert (tmp_path / "net.npz").exists()

    def no_build(*args, **kw):
        raise AssertionError("the network was built again")

    monkeypatch.setattr(synthetic, "build_prefix_tree", no_build)
    assert bench.run(device="cpu", out=io.StringIO(), **knobs)["knobs"]["net_cache"] == path
    with pytest.raises(AssertionError, match="built again"):
        bench.run(device="cpu", out=io.StringIO(), **dict(knobs, net_cache=""))


def test_canaries_catch_a_wrong_decode(monkeypatch):
    """The planted canary fails when the decode misses the planted words,
    and the cross-device canary when the scores of its first decode (the
    device's) part from the second's (the CPU's)."""
    bench.planted_canary("cpu")
    decode_scores = bench.TreeDecoder.decode_scores
    calls = itertools.count()

    def device_off(self, *args, **kw):
        res = decode_scores(self, *args, **kw)
        if next(calls) % 2 == 0:
            for r in res:
                r.score += 0.1 * max(1.0, abs(r.score))
        return res

    monkeypatch.setattr(bench.TreeDecoder, "decode_scores", device_off)
    with pytest.raises(AssertionError, match="vs cpu decode"):
        bench.cross_device_canary("cpu")

    def first_word_only(self, *args, **kw):
        res = decode_scores(self, *args, **kw)
        for r in res:
            r.lemmas = r.lemmas[:1]
        return res

    monkeypatch.setattr(bench.TreeDecoder, "decode_scores", first_word_only)
    with pytest.raises(AssertionError, match="planted canary"):
        bench.planted_canary("cpu")


TRAIN_TINY = dict(train=True, train_dmodel=16, train_blocks=1, train_batch=2, train_frames=12,
                  train_steps=2, classes=10)


def test_train_run_prints_one_result_line(monkeypatch):
    """BENCH_TRAIN=1 at a tiny width: one torch_train_mfu line with the
    step times, the MFU against 989 TFLOP/s by default, no vs_baseline."""
    out = io.StringIO()
    record = bench.run(device="cpu", out=out, **TRAIN_TINY)
    (line,) = out.getvalue().splitlines()
    assert json.loads(line) == record
    assert record["metric"] == "torch_train_mfu" and record["unit"] == "percent_of_peak"
    assert {"value", "step_ms", "frames_per_s", "achieved_tflops", "step_ms_with_upload",
            "peak_gib", "device", "card"} <= set(record) and "vs_baseline" not in record
    cfg = dict(CONFORMER, d_model=16, num_blocks=1)
    flop = bench.train_step_flop(cfg, 10, 2, 12)
    assert record["flop_per_step"] == flop
    np.testing.assert_allclose(record["achieved_tflops"], flop / record["step_ms"] / 1e9)
    np.testing.assert_allclose(record["value"], record["achieved_tflops"] / 989.0 * 100)
    np.testing.assert_allclose(record["frames_per_s"], 24 / record["step_ms"] * 1e3)
    assert record["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert record["peak_gib"] is None and record["card"] is None
    # the knobs come from bench.py's environment variables
    env = {"BENCH_TRAIN": "1", "BENCH_TRAIN_DMODEL": "16", "BENCH_TRAIN_BLOCKS": "1",
           "BENCH_TRAIN_BATCH": "2", "BENCH_TRAIN_FRAMES": "12", "BENCH_TRAIN_STEPS": "2",
           "BENCH_CLASSES": "10", "BENCH_TRAIN_PEAK_TFLOPS": "100"}
    knobs = bench.knobs_from_env(env)
    assert knobs == dict(TRAIN_TINY, train_peak_tflops=100.0)
    again = bench.run(device="cpu", out=io.StringIO(), **knobs)
    np.testing.assert_allclose(again["value"], again["achieved_tflops"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_flop_count_matches_the_flop_counter(dtype):
    """3 x conformer_flop against what FlopCounterMode counts in one
    training step (every matrix product and convolution, forward and
    backward). Two known differences, both stated exactly: the analytic
    count includes the input projection's gradient with respect to the
    input features, which autograd does not compute (within 1% of the
    step); and FlopCounterMode counts the depthwise convolution's weight
    gradient as if the convolution were dense (it leaves out ``groups``:
    d x k MACs per frame counted as d x d x k)."""
    cfg = dict(CONFORMER, d_model=64, num_blocks=2)
    B, T, classes = 2, 50, 100
    net = ConformerEncoderNet(classes, bench.TRAIN_FEAT_DIM, **cfg, compute_dtype=dtype,
                              device="cpu")
    trainer = SequenceTrainer(net, classes, TrainConfig())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, T, bench.TRAIN_FEAT_DIM)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, classes, size=(B, T)).astype(np.int32))
    with FlopCounterMode(display=False) as counter:
        trainer._update(x, y, torch.ones(B, T))
    counted = counter.get_total_flops()
    analytic = bench.train_step_flop(cfg, classes, B, T)
    d, k = cfg["d_model"], cfg["conv_kernel"]
    skipped = 2.0 * B * T * bench.TRAIN_FEAT_DIM * d
    dense_wgrad = cfg["num_blocks"] * 2.0 * B * T * k * d * (d - 1)
    assert skipped / analytic < 0.01
    assert counted - dense_wgrad == pytest.approx(analytic - skipped, rel=1e-9)
