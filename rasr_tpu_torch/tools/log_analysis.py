"""log-analysis tool: aggregate recognition logs into WER/RTF reports.

The reference ecosystem analyzes recognition runs with the `analog`
script over the recognizer's XML logs (ref: SURVEY §5 — "RASR's
analog-style log analysis is done by external scripts over the XML
logs"; the per-segment <recognized> elements carry hypothesis,
reference, score and timing). Here the recognizer emits the same
semantic fields as JSONL (pipeline/recognizer.py `recognized` records),
and this tool is the in-tree analog: it merges one or more logs —
partitioned recognition jobs write independent logs, exactly like the
reference's corpus-partition scale-out — and prints corpus / per-speaker
WER with substitution/deletion/insertion breakdown, RTF and score
statistics, plus the worst segments.

    python -m rasr_tpu_torch.tools.log_analysis job0.log job1.log
    python -m rasr_tpu_torch.tools.log_analysis --log-analysis.json=true r.log
"""

from __future__ import annotations

import json
from typing import Dict, List

from ..lattice.evaluator import EditStats, align_tokens
from ..utils.component import ParameterBool, ParameterFloat, ParameterInt
from .application import Application


def _parse_records(paths: List[str]) -> List[dict]:
    """All `recognized` statistics records across the given JSONL logs."""
    recs: List[dict] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # tolerate truncated tails of live logs
                if rec.get("msg") == "recognized" and "recognized" in rec:
                    recs.append(rec)
    return recs


def analyze(records: List[dict], frame_shift_s: float = 0.01) -> dict:
    """Aggregate recognition records (pure function, used by the tool and
    tests). Returns totals, per-speaker breakdown, and per-segment rows
    sorted worst-first by error count."""
    total = EditStats()
    by_speaker: Dict[str, EditStats] = {}
    segments: List[dict] = []
    rtf_sum = rtf_max = 0.0
    score_sum = 0.0
    audio_s = 0.0
    scored = 0
    for rec in records:
        ref = str(rec.get("reference") or "")
        hyp = str(rec.get("recognized") or "")
        row = {
            "segment": rec.get("segment", "?"),
            "speaker": rec.get("speaker", "") or "",
            "ref": ref,
            "hyp": hyp,
        }
        if ref:
            stats, _ = align_tokens(ref.split(), hyp.split())
            total.add(stats)
            by_speaker.setdefault(row["speaker"], EditStats()).add(stats)
            row.update(stats.report())
            scored += 1
        rtf = float(rec.get("rtf", 0.0))
        rtf_sum += rtf
        rtf_max = max(rtf_max, rtf)
        score_sum += float(rec.get("score", 0.0))
        audio_s += float(rec.get("frames", 0)) * frame_shift_s
        segments.append(row)
    n = len(records)
    segments.sort(key=lambda r: -r.get("errors", -1))
    return {
        "segments": n,
        "scored_segments": scored,
        "total": total.report(),
        "by_speaker": {s: e.report() for s, e in sorted(by_speaker.items())},
        "mean_rtf": rtf_sum / n if n else 0.0,
        "max_rtf": rtf_max,
        "mean_score": score_sum / n if n else 0.0,
        "audio_seconds": audio_s,
        "worst": segments,
    }


class LogAnalysisTool(Application):
    name = "log-analysis"
    description = "aggregate recognition JSONL logs into WER/RTF reports"

    frame_shift = ParameterFloat(
        "frame-shift", default=0.01, doc="seconds per frame (audio-time recovery)"
    )
    worst = ParameterInt(
        "worst", default=0, doc="print the N segments with the most errors"
    )
    json_out = ParameterBool(
        "json", default=False, doc="print one machine-readable JSON summary line"
    )
    per_speaker = ParameterBool(
        "per-speaker", default=True, doc="print the per-speaker WER table"
    )

    def run(self, args: List[str]) -> int:
        if not args:
            print("no log files given")
            return 1
        report = analyze(_parse_records(args), self.frame_shift)
        if self.json_out:
            out = {k: v for k, v in report.items() if k != "worst"}
            print(json.dumps(out))
            return 0
        t = report["total"]
        print(
            f"segments: {report['segments']} "
            f"(scored: {report['scored_segments']})  "
            f"audio: {report['audio_seconds']:.1f}s  "
            f"mean RTF: {report['mean_rtf']:.4f}  max RTF: {report['max_rtf']:.4f}"
        )
        print(
            f"WER: {t['wer']:.4f} ({t['errors']} errors / {t['ref_len']} words: "
            f"{t['sub']} sub / {t['del']} del / {t['ins']} ins)"
        )
        if self.per_speaker and any(s for s in report["by_speaker"] if s):
            print("per-speaker:")
            for spk, e in report["by_speaker"].items():
                print(
                    f"  {spk or '(none)':<16} WER {e['wer']:.4f} "
                    f"({e['errors']}/{e['ref_len']}: "
                    f"{e['sub']} sub / {e['del']} del / {e['ins']} ins)"
                )
        for row in report["worst"][: self.worst]:
            if row.get("errors", 0) > 0:
                print(
                    f"worst: {row['segment']} errors={row['errors']} "
                    f"ref={row['ref']!r} hyp={row['hyp']!r}"
                )
        return 0


if __name__ == "__main__":
    raise SystemExit(LogAnalysisTool.main())
