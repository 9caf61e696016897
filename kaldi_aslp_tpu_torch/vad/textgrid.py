"""Praat TextGrid generation from VAD intervals.

Port of kaldi_aslp_tpu/vad/textgrid.py (reference:
aslp_scripts/vad/gen_textgrid_according_vad_interval.py): speech
segments (frame-index intervals at 10 ms) as a Praat IntervalTier, with
the reference's labels: the first speech interval "1", the last "2", the
middle ones "V", and "N" filler intervals for silences longer than
200 ms.  Plain text, byte for byte the JAX package's."""

from __future__ import annotations

from typing import List, Sequence, Tuple

FRAME_RATE = 100.0  # 10ms frames


def intervals_to_textgrid(intervals: Sequence[Tuple[int, int]],
                          tier_name: str = "vad") -> str:
    """Render [(start_frame, end_frame), ...] speech intervals as a
    TextGrid document string."""
    if not intervals:
        raise ValueError("no VAD intervals")
    rows: List[Tuple[float, float, str]] = []
    last_xmax = 0
    for k, (xmin, xmax) in enumerate(intervals):
        if last_xmax >= xmin:
            xmin = last_xmax
        elif xmin > last_xmax + 20:  # >200ms silence gap
            rows.append((last_xmax / FRAME_RATE, xmin / FRAME_RATE, "N"))
        if k == 0:
            text = "1"
        elif k == len(intervals) - 1:
            text = "2"
        else:
            text = "V"
        rows.append((xmin / FRAME_RATE, xmax / FRAME_RATE, text))
        last_xmax = xmax

    end_time = intervals[-1][1] / FRAME_RATE
    out = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "xmin = 0",
        "xmax = %s" % (end_time,),
        "tiers? <exists>",
        "size = 1",
        "item []:",
        "\titem [1]:",
        '\t\tclass = "IntervalTier"',
        '\t\tname = "%s"' % tier_name,
        "\t\txmin = 0",
        "\t\txmax = %s" % (end_time,),
        "\t\tintervals: size = %d" % len(rows),
    ]
    for i, (xmin, xmax, text) in enumerate(rows, 1):
        out.append("\t\tintervals [%d]:" % i)
        out.append("\t\t\txmin = %s" % (xmin,))
        out.append("\t\t\txmax = %s" % (xmax,))
        out.append('\t\t\ttext = "%s"' % text)
    return "\n".join(out) + "\n"


def parse_interval_file(text: str) -> List[Tuple[int, int]]:
    """Parse a segment.info-style file: one "[start, end]" or
    "start end" pair per line (frame indices)."""
    intervals: List[Tuple[int, int]] = []
    for line in text.splitlines():
        parts = (line.replace("[", " ").replace("]", " ")
                 .replace(",", " ").split())
        if len(parts) >= 2:
            intervals.append((int(parts[0]), int(parts[1])))
    return intervals
