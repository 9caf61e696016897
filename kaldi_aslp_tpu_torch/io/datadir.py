"""Kaldi data-dir text files: ``key value...`` lines.

The port's copy of ``read_key_value`` from kaldi_aslp_tpu/io/datadir.py
(reference: utils/ data-dir conventions, one ``key rest`` per line),
which ``compute-wer`` reads its transcripts with."""

from __future__ import annotations

from typing import Dict


def read_key_value(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, rest = line.partition(" ")
            out[key] = rest.strip()
    return out
