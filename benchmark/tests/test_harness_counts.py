"""The work counts equal hand-worked values."""

import json
import math

import pytest

from benchmark import counts, spec
from benchmark.counts import conformer, frontend, gmm

GMM = json.loads((spec.HERE / "configs" / "rasr-gmm-5k.json").read_text())
CONF = json.loads((spec.HERE / "configs" / "conformer-hybrid.json").read_text())


def test_gmm_at_64_by_998():
    w = gmm.work(64 * 998, GMM)
    assert w.flop["tf32x3"] == pytest.approx(1.84e11, rel=2e-3)
    assert w.flop["tf32x3"] == 4 * 63872 * 45 * 2000 * 8
    # three TF32 products at 495 TFLOP/s: chip_smoke.py's 1.115-ms bound
    assert w.least_seconds() == pytest.approx(3 * 4 * 63872 * 45 * 16000 / 495e12)
    assert w.least_seconds() * 1e3 == pytest.approx(1.115, abs=1e-3)


def test_conformer_flop_against_the_formula():
    c = CONF["conformer"]
    d, L, T = 512, 12, 998
    macs = 2 * 2 * d * 4 * d + 4 * d * d + d * 2 * d + d * d + d * 32 + T * d
    lo, hi = conformer.conformer_flop(c, 45, 9001, T)
    assert lo == 2.0 * (45 * d + L * macs + d * 9001)
    assert hi == 2.0 * L * T * d
    step = conformer.train_step_work(32, 400, CONF)
    assert step.flop["bf16"] == pytest.approx(6.1e12, rel=0.01)
    assert step.flop["fp32"] == pytest.approx(1.89e11, rel=0.01)


def test_conformer_forward_counts_each_utterance_at_its_length():
    w = conformer.forward_work([100, 300], CONF)
    a = conformer.conformer_flop(CONF["conformer"], 45, 9001, 100)
    b = conformer.conformer_flop(CONF["conformer"], 45, 9001, 300)
    assert w.flop["bf16"] == 100 * a[0] + 300 * b[0]
    assert w.flop["fp32"] == 100 * a[1] + 300 * b[1]


def test_frontend_counts_an_fft_not_a_dft():
    w = frontend.work([16000], [98], GMM)
    per_frame_fft = 2.5 * 512 * math.log2(512) + 3 * 257
    assert w.flop["fp32"] == pytest.approx(98 * per_frame_fft)
    assert w.flop["tf32x3"] == 98 * 2.0 * (257 * 20 + 20 * 16 + 144 * 45)
    dense_dft = 98 * 4.0 * 400 * 257
    assert w.flop["fp32"] < dense_dft / 5


def test_least_time_is_the_larger_of_ops_and_bytes():
    w = counts.Work({"bf16": 989e12, "fp32": 67e12}, 3.35e12)
    assert w.op_seconds() == pytest.approx(2.0)
    assert w.least_seconds() == pytest.approx(2.0)
    assert counts.Work({}, 6.7e12).least_seconds() == pytest.approx(2.0)
