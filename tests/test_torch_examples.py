"""PyTorch port vs JAX: the two example scripts ported last
(``rasr_tpu_torch/examples/streaming_demo.py`` and ``beam_sweep.py``).

Each runs on the CPU beside the reference script (imported from
``examples/`` as it is, its own module-level draws), at the scripts' own
size (a few seconds each). The demo's stream equals its offline decode
(asserted inside, as the reference does), and the port's partial and
final hypotheses are the reference's. The sweep keeps the curve's shape
(asserted inside) and each K's hypotheses are the reference's, word for
word, on all 24 test utterances.
"""

import importlib.util
import re
from pathlib import Path

from rasr_tpu_torch.examples import beam_sweep, streaming_demo

REPO = Path(__file__).resolve().parent.parent


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_streaming_demo_matches_reference(capsys):
    _reference("streaming_demo").main()
    printed = capsys.readouterr().out
    want_partials = re.findall(r"partial: '([^']*)'", printed)
    want_final = re.search(r"final:\s+'([^']*)'", printed).group(1)
    got = streaming_demo.run("cpu", say=lambda _: None)
    assert got["final"].orth == got["offline"].orth == want_final
    assert got["partials"] == want_partials


def test_beam_sweep_matches_reference(monkeypatch):
    ref = _reference("beam_sweep")
    hyps = []

    class Recording(ref.CorpusEvaluator):
        def add(self, segment, reference, hypothesis):
            hyps.append(hypothesis)
            return super().add(segment, reference, hypothesis)

    monkeypatch.setattr(ref, "CorpusEvaluator", Recording)
    ref.main()
    got = beam_sweep.run("cpu", say=lambda _: None)
    n = len(hyps) // len(beam_sweep.KS)
    for i, K in enumerate(beam_sweep.KS):
        assert got["hyps"][K] == hyps[i * n:(i + 1) * n], K
