"""Syllable-prep CLI tools (reference: aslp_scripts/syllable/*.py).

Port of the four syllable tools of kaldi_aslp_tpu/cli/script_tools.py
(``aslp-convert-lexicon-to-syllable``, ``aslp-bind-syllable``,
``aslp-bind-lexicon``, ``aslp-ali-to-syllable``): plain Python on the
port's ops/syllable.py, the same arguments and the same output text.
The log-analysis and TextGrid tools of that file are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def _read_lines(path: str):
    with open(path) as f:
        return f.read().splitlines()


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
