"""Script-role CLI tools: log analysis, syllable prep, TextGrid, KWS text
prep (reference: aslp_scripts/log_analyse.sh, log_analyse_ctc.sh,
mpi_log_analyse.sh, aslp_scripts/syllable/*.py,
aslp_scripts/vad/gen_textgrid_according_vad_interval.py,
aslp_scripts/kws/gen_text_fst.py, generate_simulation_ali.py).

Port of kaldi_aslp_tpu/cli/script_tools.py: plain Python on the port's
ops/syllable.py, vad/textgrid.py and kws/text_fst.py, the same arguments
and the same output text.  The log tools read the ``ProgressLoss[...]``
lines that the port's ``LossReporter`` logs (models/losses.py), the
JAX package's format.  None takes ``--device``.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys


def _read_lines(path: str):
    with open(path) as f:
        return f.read().splitlines()


_PROGRESS_RE = re.compile(r"ProgressLoss\[[^\]]*\]:.*?(-?\d+(?:\.\d+)?)\s*$")


def _progress_values(lines):
    out = []
    for line in lines:
        m = _PROGRESS_RE.search(line)
        if m:
            out.append(float(m.group(1)))
    return out


def log_analyse(argv):
    """Extract the ProgressLoss curve from a training log
    (log_analyse.sh / log_analyse_ctc.sh: grep Progress | awk)."""
    p = argparse.ArgumentParser(prog="aslp-log-analyse")
    p.add_argument("--sum", type=int, default=121,
                   help="progress lines per iteration")
    p.add_argument("--stride", type=int, default=5,
                   help="print every stride-th value within an iter")
    p.add_argument("log_file")
    a = p.parse_args(argv)
    vals = _progress_values(_read_lines(a.log_file))
    for n, v in enumerate(vals):
        it = 1 + n // a.sum
        if n % a.sum == 0 or (n - it) % a.stride == 0:
            print(v)
    return 0


def mpi_log_analyse(argv):
    """Per-worker loss curves from a parallel-train log dir
    (mpi_log_analyse.sh: iter*.tr.log* files, 0-separated)."""
    p = argparse.ArgumentParser(prog="aslp-mpi-log-analyse")
    p.add_argument("log_dir")
    p.add_argument("--pattern", default="iter*.tr.log*")
    a = p.parse_args(argv)
    files = sorted(glob.glob(os.path.join(a.log_dir, a.pattern)))
    if not files:
        print("no logs matching %s in %s" % (a.pattern, a.log_dir),
              file=sys.stderr)
        return 1
    for path in files:
        print(0)
        for v in _progress_values(_read_lines(path)):
            print(v)
    return 0


def convert_lexicon_to_syllable(argv):
    """Phone lexicon -> syllable lexicon + syllable table on stdout
    (aslp_scripts/syllable/convert_lexicon_to_syllable.py)."""
    from kaldi_aslp_tpu_torch.ops.syllable import lexicon_to_syllable

    p = argparse.ArgumentParser(prog="aslp-convert-lexicon-to-syllable")
    p.add_argument("phone_lexicon")
    p.add_argument("syllable_lexicon")
    a = p.parse_args(argv)
    rows = [ln.split() for ln in _read_lines(a.phone_lexicon) if ln.split()]
    syl_rows, table = lexicon_to_syllable(rows)
    with open(a.syllable_lexicon, "w") as f:
        for row in syl_rows:
            f.write(" ".join(row) + "\n")
    for syl, phones in table.items():
        print(syl, phones)
    return 0


def bind_syllable_cli(argv):
    """Tone-bind low-frequency syllables from a count file
    (aslp_scripts/syllable/bind_syllable.py)."""
    from kaldi_aslp_tpu_torch.ops.syllable import bind_syllables

    p = argparse.ArgumentParser(prog="aslp-bind-syllable")
    p.add_argument("--thresh", type=int, default=50)
    p.add_argument("count_file")
    a = p.parse_args(argv)
    counts = {}
    for ln in _read_lines(a.count_file):
        parts = ln.split()
        if len(parts) == 2:
            counts[parts[0]] = int(parts[1])
    bind = bind_syllables(counts, thresh=a.thresh)
    for s in counts:
        if s in bind:
            print(s, bind[s], s == bind[s])
        else:
            print(s, "Not bind", file=sys.stderr)
    return 0


def bind_lexicon_cli(argv):
    """Apply a bind map to a syllable lexicon
    (aslp_scripts/syllable/bind_lexicon.py)."""
    from kaldi_aslp_tpu_torch.ops.syllable import bind_lexicon

    p = argparse.ArgumentParser(prog="aslp-bind-lexicon")
    p.add_argument("bind_info")
    p.add_argument("lexicon_file")
    a = p.parse_args(argv)
    bind = {}
    for ln in _read_lines(a.bind_info):
        parts = ln.split()
        if len(parts) >= 2:
            bind[parts[0]] = parts[1]
    rows = [ln.split() for ln in _read_lines(a.lexicon_file) if ln.split()]
    for row in bind_lexicon(rows, bind):
        print(" ".join(row))
    return 0


def ali_to_syllable_cli(argv):
    """Per-frame phone ali (stdin, "utt id id ...") -> syllable ali
    (aslp_scripts/syllable/ali_to_syllable.py)."""
    from kaldi_aslp_tpu_torch.ops.syllable import ali_to_syllable

    p = argparse.ArgumentParser(prog="aslp-ali-to-syllable")
    p.add_argument("phones_txt", help="phone symbol table: NAME ID")
    p.add_argument("syllable_txt", help="syllable table: NAME ID")
    p.add_argument("bind_info")
    a = p.parse_args(argv)
    phone_names = {}
    for ln in _read_lines(a.phones_txt):
        parts = ln.split()
        if len(parts) == 2:
            phone_names[int(parts[1])] = parts[0]
    syllable_ids = {}
    for ln in _read_lines(a.syllable_txt):
        parts = ln.split()
        if len(parts) == 2:
            syllable_ids[parts[0]] = int(parts[1])
    bind = {}
    for ln in _read_lines(a.bind_info):
        parts = ln.split()
        if len(parts) >= 2:
            bind[parts[0]] = parts[1]
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        ali = [int(x) for x in parts[1:]]
        out = ali_to_syllable(ali, phone_names, syllable_ids, bind)
        print(parts[0], " ".join(str(x) for x in out))
    return 0


def gen_textgrid(argv):
    """VAD interval file -> Praat TextGrid
    (aslp_scripts/vad/gen_textgrid_according_vad_interval.py)."""
    from kaldi_aslp_tpu_torch.vad.textgrid import (
        intervals_to_textgrid,
        parse_interval_file,
    )

    p = argparse.ArgumentParser(prog="aslp-gen-textgrid")
    p.add_argument("interval_file")
    p.add_argument("out_textgrid")
    a = p.parse_args(argv)
    with open(a.interval_file) as f:
        intervals = parse_interval_file(f.read())
    name = os.path.splitext(os.path.basename(a.out_textgrid))[0]
    with open(a.out_textgrid, "w") as f:
        f.write(intervals_to_textgrid(intervals, tier_name=name))
    return 0


def kws_gen_text_fst(argv):
    """Keyword phone list -> keyword-filler text FST
    (aslp_scripts/kws/gen_text_fst.py)."""
    from kaldi_aslp_tpu_torch.kws.text_fst import (
        build_keyword_filler_text_fst,
    )

    p = argparse.ArgumentParser(prog="aslp-kws-gen-text-fst")
    p.add_argument("keyword_phone_file",
                   help="lines: KEYWORD ph1 ph2 ...")
    p.add_argument("text_fst_file")
    a = p.parse_args(argv)
    keywords = {}
    for ln in _read_lines(a.keyword_phone_file):
        parts = ln.split()
        if len(parts) >= 2:
            keywords[parts[0]] = parts[1:]
    with open(a.text_fst_file, "w") as f:
        f.write(build_keyword_filler_text_fst(keywords))
    return 0


def kws_generate_simulation_ali(argv):
    """Clean ali (stdin) + simulated wav.scp -> simulated ali (stdout)
    (aslp_scripts/kws/generate_simulation_ali.py)."""
    from kaldi_aslp_tpu_torch.kws.text_fst import simulation_ali

    p = argparse.ArgumentParser(prog="aslp-kws-generate-simulation-ali")
    p.add_argument("wav_scp")
    a = p.parse_args(argv)
    clean = {}
    for line in sys.stdin:
        parts = line.split()
        if parts:
            clean[parts[0]] = parts[1:]
    sim_keys = [ln.split()[0] for ln in _read_lines(a.wav_scp)
                if ln.split()]
    for key, ali in simulation_ali(clean, sim_keys).items():
        print(key, " ".join(str(x) for x in ali))
    return 0
