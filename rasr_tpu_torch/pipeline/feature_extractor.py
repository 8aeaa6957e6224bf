"""Feature extraction driver: corpus -> feature caches.

Re-implements the reference's feature-extraction pipeline driver
(ref: src/Speech/FeatureExtractor.* + the Flow cache nodes): visit the
corpus in batches, run the batched frontend, persist per-segment feature
matrices into a cache archive keyed by segment full name — idempotent
(existing entries are skipped) so reruns are incremental, exactly the
reference's cache semantics.

The port's copy of ``rasr_tpu/pipeline/feature_extractor.py``: the
frontend runs on its own device, per-speaker feature transforms (fMLLR,
``train/fmllr.py``) apply there as one batched ``[B, D, D]`` product,
and each batch's features come to the host once.
"""

from __future__ import annotations

import numpy as np

from ..ops.frontend import FeatureFrontend
from ..train.fmllr import transform_batch
from ..utils.archive import FileArchive, pack_ndarray, unpack_ndarray
from ..utils.logging import LogManager
from .visitor import CorpusVisitor


class FeatureExtractor:
    def __init__(self, frontend: FeatureFrontend, cache_path: str,
                 feature_transforms=None):
        self.frontend = frontend
        self.cache_path = cache_path
        #: optional per-speaker fMLLR transforms applied before caching
        self.feature_transforms = feature_transforms
        self.log = LogManager.get().channel("feature-extraction", "log")

    def run(self, visitor: CorpusVisitor, overwrite: bool = False) -> int:
        written = 0
        with FileArchive(self.cache_path, "a") as archive:
            for batch in visitor.batches():
                todo = [
                    i for i, name in enumerate(batch.names)
                    if overwrite or name not in archive
                ]
                if not todo:
                    continue
                feats, n_frames = self.frontend(batch.samples, batch.lengths)
                if self.feature_transforms:
                    feats = transform_batch(feats, batch.segments, self.feature_transforms)
                feats = feats.cpu().numpy()
                n_frames = n_frames.cpu().numpy()
                for i in todo:
                    name = batch.names[i]
                    archive.write(
                        name, pack_ndarray(feats[i, : int(n_frames[i])])
                    )
                    written += 1
                self.log(
                    "batch extracted",
                    segments=len(todo),
                    frames=int(n_frames.sum()),
                )
        return written


def load_features(cache_path: str, name: str) -> np.ndarray:
    with FileArchive(cache_path, "r") as archive:
        return unpack_ndarray(archive.read(name))
