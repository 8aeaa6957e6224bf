"""The acoustic models, one module each, found by name.

A configuration's ``"scorer"`` names ``benchmark/models/<scorer>.py``
(``spec.model``); a new architecture is a new module here, its plain
reference under ``benchmark/reference/`` and its work counts under
``benchmark/counts/``, with no edit to the jobs or to ``system.py``. A
module builds the port's objects inside its functions (importing
``rasr_tpu_torch`` there) and hands the plain reference the same draws and
weights. It provides, for every job:

- ``draw(cfg, rng, M, D) -> dict``: the model's host-side draws from the
  run's ``numpy`` generator (``M`` classes, ``D`` feature dimensions);
  ``system.draw`` keeps them as ``Draws.acoustic``.
- ``weights(cfg, seed, device) -> dict | None``: the weights drawn on the
  device, as the port's ``state_dict`` names them; None where the draws
  are the whole model.
- ``tiny(cfg)``: cut the model's own sizes for the CPU tests
  (``benchmark/tests/tiny.py``), in place.

for the decode job (and the align job):

- ``scorer(cfg, draws, weights, device)``: the port's ``FeatureScorer``.
- ``forward_work(frames, cfg) -> counts.Work``: scoring utterances of
  ``frames`` frames each.
- ``reference_scores(feats, draws, weights, cfg, quant=None)``: the plain
  reference's emission scores of one utterance's ``feats [T, D]``; with
  ``quant`` (``reference/precision.py``) the lower-precision control.

for the train job, which trains a network:

- ``net(cfg, weights, device)``: the port's ``nn.Module`` with ``weights``
  loaded.
- ``train_step_work(batch, frames, cfg) -> counts.Work``: one step.
- ``reference_logits(x, params, cfg, quant)``: the plain reference's
  logits of one utterance ``x [T, D]`` from ``params`` (named as the
  weights), each product's operands rounded by the callable ``quant``
  where it is not None.

and for the align job, which accumulates EM statistics:

- ``mixtures(cfg, draws)``: the port's ``MixtureSet`` the statistics
  accumulate into.
"""
