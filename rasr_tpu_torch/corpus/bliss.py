"""Bliss corpus description parsing.

Parses the reference's corpus XML format
(ref: src/Bliss/CorpusDescription.*):

.. code-block:: xml

    <corpus name="train">
      <speaker-description name="spk1"><gender>male</gender></speaker-description>
      <include file="more.corpus"/>
      <subcorpus name="part1">
        <recording name="rec1" audio="rec1.wav">
          <segment name="seg1" start="0.0" end="2.5" track="0">
            <speaker name="spk1"/>
            <orth>HELLO WORLD</orth>
          </segment>
        </recording>
      </subcorpus>
    </corpus>

Segments carry fully-qualified names ``corpus/subcorpus/recording/segment``.
Partition selection (``partition N of M``) and explicit segment lists mirror
the reference's corpus-visitor parameters, which are the unit of
(file-level) data parallelism there; here they shard utterance batches.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from ..utils.xmlio import parse_xml
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional


@dataclass
class Speaker:
    name: str
    gender: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)


@dataclass
class Segment:
    name: str  # short name
    full_name: str  # corpus/…/recording/name
    recording: "Recording"
    start: float = 0.0
    end: float = float("inf")
    track: int = 0
    orth: str = ""
    speaker: Optional[str] = None
    condition: Optional[str] = None

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class Recording:
    name: str
    full_name: str
    audio: str
    segments: List[Segment] = field(default_factory=list)


class CorpusDescription:
    """Parsed corpus with flat segment iteration and partition selection."""

    def __init__(self, name: str = ""):
        self.name = name
        self.recordings: List[Recording] = []
        self.speakers: Dict[str, Speaker] = {}

    # ----------------------------------------------------------------- parse
    @classmethod
    def load(cls, path: str, audio_dir: str = "") -> "CorpusDescription":
        tree = parse_xml(path)
        root = tree.getroot()
        if root.tag != "corpus":
            raise ValueError(f"{path}: root element must be <corpus>")
        corpus = cls(root.get("name", os.path.basename(path)))
        base_dir = os.path.dirname(os.path.abspath(path))
        corpus._parse_section(root, corpus.name, base_dir, audio_dir)
        return corpus

    def _parse_section(self, elem: ET.Element, prefix: str, base_dir: str, audio_dir: str) -> None:
        for child in elem:
            if child.tag == "speaker-description":
                spk = Speaker(child.get("name", ""))
                for sub in child:
                    if sub.tag == "gender":
                        spk.gender = (sub.text or "").strip()
                    else:
                        spk.attributes[sub.tag] = (sub.text or "").strip()
                self.speakers[spk.name] = spk
            elif child.tag == "include":
                inc = child.get("file", "")
                if not os.path.isabs(inc):
                    inc = os.path.join(base_dir, inc)
                sub_tree = parse_xml(inc).getroot()
                self._parse_section(sub_tree, prefix, os.path.dirname(inc), audio_dir)
            elif child.tag == "subcorpus":
                self._parse_section(
                    child, f"{prefix}/{child.get('name', '')}", base_dir, audio_dir
                )
            elif child.tag == "recording":
                self._parse_recording(child, prefix, audio_dir)

    def _parse_recording(self, elem: ET.Element, prefix: str, audio_dir: str) -> None:
        name = elem.get("name", "")
        audio = elem.get("audio", "")
        if audio_dir and audio and not os.path.isabs(audio):
            audio = os.path.join(audio_dir, audio)
        rec = Recording(name=name, full_name=f"{prefix}/{name}", audio=audio)
        default_idx = 0
        for seg_elem in elem.findall("segment"):
            default_idx += 1
            seg_name = seg_elem.get("name", str(default_idx))
            seg = Segment(
                name=seg_name,
                full_name=f"{rec.full_name}/{seg_name}",
                recording=rec,
                start=float(seg_elem.get("start", "0")),
                end=float(seg_elem.get("end", "inf")),
                track=int(seg_elem.get("track", "0")),
            )
            orth_elem = seg_elem.find("orth")
            if orth_elem is not None:
                seg.orth = " ".join((orth_elem.text or "").split())
            spk_elem = seg_elem.find("speaker")
            if spk_elem is not None:
                seg.speaker = spk_elem.get("name")
            cond_elem = seg_elem.find("condition")
            if cond_elem is not None:
                seg.condition = cond_elem.get("name")
            rec.segments.append(seg)
        self.recordings.append(rec)

    # --------------------------------------------------------------- iterate
    def segments(
        self,
        partition: int = 0,
        num_partitions: int = 1,
        segment_list: Optional[List[str]] = None,
    ) -> Iterator[Segment]:
        """Iterate segments, optionally restricted to a partition / name list.

        Partitioning is contiguous by segment index, matching the
        reference's corpus-partition semantics.
        """
        allow = set(segment_list) if segment_list is not None else None
        all_segs = [s for rec in self.recordings for s in rec.segments]
        if allow is not None:
            all_segs = [s for s in all_segs if s.full_name in allow or s.name in allow]
        if num_partitions > 1:
            n = len(all_segs)
            lo = (n * partition) // num_partitions
            hi = (n * (partition + 1)) // num_partitions
            all_segs = all_segs[lo:hi]
        yield from all_segs

    def statistics(self) -> Dict[str, float]:
        segs = list(self.segments())
        total = sum(s.duration for s in segs if s.duration != float("inf"))
        return {
            "recordings": len(self.recordings),
            "segments": len(segs),
            "speakers": len(self.speakers),
            "total_duration_s": total,
        }
