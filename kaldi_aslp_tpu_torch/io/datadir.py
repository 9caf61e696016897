"""Kaldi data-directory model (reference: egs/wsj/s5/utils/validate_data_dir.sh).

A data dir is a directory of parallel text maps keyed by utterance id:
wav.scp, text, utt2spk, spk2utt, segments, feats.scp, cmvn.scp...  This
module loads/validates/writes them so reference-prepared corpora work
unchanged.

The port's own copy of kaldi_aslp_tpu/io/datadir.py (plain Python; the
JAX package's ``io/__init__`` loads JAX)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


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


def write_key_value(path: str, mapping: Dict[str, str]) -> None:
    with open(path, "w") as f:
        for key in sorted(mapping):
            f.write(f"{key} {mapping[key]}\n")


@dataclass
class DataDir:
    path: str
    wav_scp: Dict[str, str] = field(default_factory=dict)
    text: Dict[str, str] = field(default_factory=dict)
    utt2spk: Dict[str, str] = field(default_factory=dict)
    feats_scp: Dict[str, str] = field(default_factory=dict)
    cmvn_scp: Dict[str, str] = field(default_factory=dict)
    segments: Dict[str, Tuple[str, float, float]] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "DataDir":
        d = cls(path=path)
        def maybe(name):
            p = os.path.join(path, name)
            return read_key_value(p) if os.path.exists(p) else {}
        d.wav_scp = maybe("wav.scp")
        d.text = maybe("text")
        d.utt2spk = maybe("utt2spk")
        d.feats_scp = maybe("feats.scp")
        d.cmvn_scp = maybe("cmvn.scp")
        seg = maybe("segments")
        d.segments = {
            k: (v.split()[0], float(v.split()[1]), float(v.split()[2]))
            for k, v in seg.items()
        }
        return d

    def save(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        if self.wav_scp:
            write_key_value(os.path.join(self.path, "wav.scp"), self.wav_scp)
        if self.text:
            write_key_value(os.path.join(self.path, "text"), self.text)
        if self.utt2spk:
            write_key_value(os.path.join(self.path, "utt2spk"), self.utt2spk)
            write_key_value(
                os.path.join(self.path, "spk2utt"),
                {s: " ".join(us) for s, us in self.spk2utt().items()},
            )
        if self.feats_scp:
            write_key_value(os.path.join(self.path, "feats.scp"), self.feats_scp)
        if self.segments:
            write_key_value(
                os.path.join(self.path, "segments"),
                {k: f"{r} {s} {e}" for k, (r, s, e) in self.segments.items()},
            )

    def spk2utt(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for utt, spk in self.utt2spk.items():
            out.setdefault(spk, []).append(utt)
        for utts in out.values():
            utts.sort()
        return out

    def utt_ids(self) -> List[str]:
        for source in (self.feats_scp, self.wav_scp, self.text):
            if source:
                return sorted(source)
        return []

    def validate(self) -> List[str]:
        """Return a list of problems (empty = valid)."""
        problems = []
        utts = set(self.utt_ids())
        for name, mapping in (("text", self.text), ("utt2spk", self.utt2spk)):
            if mapping and set(mapping) != utts:
                missing = utts - set(mapping)
                extra = set(mapping) - utts
                if missing:
                    problems.append(f"{name}: missing {sorted(missing)[:5]}")
                if extra:
                    problems.append(f"{name}: extra {sorted(extra)[:5]}")
        return problems


def split_data_dir(d: DataDir, num_jobs: int) -> List[DataDir]:
    """Shard a data dir into nj pieces (reference: utils/split_data.sh)."""
    utts = d.utt_ids()
    shards = []
    for j in range(num_jobs):
        sub = DataDir(path=os.path.join(d.path, f"split{num_jobs}", str(j + 1)))
        keys = utts[j::num_jobs]
        for k in keys:
            if k in d.wav_scp:
                sub.wav_scp[k] = d.wav_scp[k]
            if k in d.text:
                sub.text[k] = d.text[k]
            if k in d.utt2spk:
                sub.utt2spk[k] = d.utt2spk[k]
            if k in d.feats_scp:
                sub.feats_scp[k] = d.feats_scp[k]
            if k in d.segments:
                sub.segments[k] = d.segments[k]
        shards.append(sub)
    return shards
