"""Feature CLI tools (reference: src/featbin/ — compute-mfcc-feats,
compute-fbank-feats, copy-feats, apply-cmvn, add-deltas, splice-feats,
compute-cmvn-stats, feat-to-dim).

Port of kaldi_aslp_tpu/cli/feat_tools.py, with the same
rspecifier/wspecifier surface, so reference recipe pipe strings work.
Every tool takes ``--device`` (default ``cuda``; without CUDA it raises
rather than run on the CPU) and computes there.  What differs from the
JAX tools, and why: ``--dither`` defaults to 0 and any other value is
refused.  The JAX tools take ``--dither`` (default 1.0) but call their
extractor without a key, so they never dither; Kaldi's tools dither by
default.  The port neither copies that silent no-op nor dithers
differently from the JAX package, so a plain call of either gives the
same undithered features."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from kaldi_aslp_tpu_torch.utils.config import Config, ConfigError, \
    parse_options


@dataclasses.dataclass
class DeviceFlags(Config):
    device: str = "cuda"


@dataclasses.dataclass
class _FrameFlags(Config):
    sample_frequency: float = 16000.0
    frame_length: float = 25.0
    frame_shift: float = 10.0
    dither: float = 0.0
    preemphasis_coefficient: float = 0.97
    window_type: str = "povey"
    snip_edges: bool = True
    num_mel_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0


def refuse_dither(tool: str, dither: float) -> None:
    """Raise for ``--dither`` other than 0 (see the module's note)."""
    if dither != 0.0:
        raise ConfigError(
            f"{tool}: --dither={dither} is refused: the port extracts "
            "undithered features only, as the JAX tool does (it takes the "
            "flag and never dithers); pass --dither=0")


def _frame_opts(f: _FrameFlags):
    from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
    from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions

    return (
        FrameExtractionOptions(
            samp_freq=f.sample_frequency, frame_length_ms=f.frame_length,
            frame_shift_ms=f.frame_shift, dither=f.dither,
            preemphasis_coefficient=f.preemphasis_coefficient,
            window_type=f.window_type, snip_edges=f.snip_edges,
        ),
        MelBanksOptions(num_bins=f.num_mel_bins, low_freq=f.low_freq,
                        high_freq=f.high_freq),
    )


def iter_wavs(rspec: str) -> Iterator[Tuple[str, object]]:
    """wav rspecifier: scp of wav paths -> (utt, WaveData)."""
    from kaldi_aslp_tpu_torch.io import read_wave
    from kaldi_aslp_tpu_torch.io.datadir import read_key_value

    kind, path = rspec.split(":", 1)
    if not kind.startswith("scp"):
        raise ValueError("wav input must be scp:")
    for utt, wav_path in read_key_value(path).items():
        yield utt, read_wave(wav_path)


def _on(mat: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(mat, np.float32)).to(device)


def _extract(argv, tool: str, make, extra=()) -> int:
    """compute-{mfcc,fbank}-feats: ``make(frame_opts, mel_opts, device)``
    builds the extractor after the flags (``extra`` too) are parsed."""
    from kaldi_aslp_tpu_torch.io import matrix_writer
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    flags, dev_flags = _FrameFlags(), DeviceFlags()
    args = parse_options(argv, [flags, dev_flags, *extra],
                         f"{tool} [--device=cuda] scp:wav.scp ark:feats.ark",
                         2, 2)
    refuse_dither(tool, flags.dither)
    extractor = make(*_frame_opts(flags), resolve_device(dev_flags.device))
    with matrix_writer(args[1]) as w:
        for utt, wav in iter_wavs(args[0]):
            w[utt] = extractor(wav.data[0]).cpu().numpy()
    return 0


@dataclasses.dataclass
class _MfccFlags(Config):
    num_ceps: int = 13
    use_energy: bool = True


def compute_mfcc_feats(argv) -> int:
    from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc, MfccOptions

    mflags = _MfccFlags()

    def make(frame_opts, mel_opts, device):
        return Mfcc(frame_opts, mel_opts,
                    MfccOptions(num_ceps=mflags.num_ceps,
                                use_energy=mflags.use_energy), device=device)
    return _extract(argv, "compute-mfcc-feats", make, [mflags])


def compute_fbank_feats(argv) -> int:
    from kaldi_aslp_tpu_torch.feats.fbank import Fbank, FbankOptions

    def make(frame_opts, mel_opts, device):
        return Fbank(frame_opts, mel_opts, FbankOptions(), device=device)
    return _extract(argv, "compute-fbank-feats", make)


def _per_matrix(argv, configs, usage, fn, keep_dtype=False) -> int:
    """Read a matrix table, write ``fn(matrix on --device)`` for each:
    float32 (the JAX tools' arrays), or the table's own type."""
    from kaldi_aslp_tpu_torch.io import matrix_writer, sequential_matrix_reader
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    dev_flags = DeviceFlags()
    args = parse_options(argv, [*configs, dev_flags], usage, 2, 2)
    device = resolve_device(dev_flags.device)
    with matrix_writer(args[1]) as w:
        for utt, mat in sequential_matrix_reader(args[0]):
            x = (torch.from_numpy(np.ascontiguousarray(mat)).to(device)
                 if keep_dtype else _on(mat, device))
            w[utt] = fn(x).cpu().numpy()
    return 0


def copy_feats(argv) -> int:
    return _per_matrix(argv, [], "copy-feats [--device=cuda] in-rspec "
                       "out-wspec", lambda m: m, keep_dtype=True)


def compute_cmvn_stats(argv) -> int:
    from kaldi_aslp_tpu_torch.feats.functions import acc_cmvn_stats
    from kaldi_aslp_tpu_torch.io import matrix_writer, sequential_matrix_reader
    from kaldi_aslp_tpu_torch.io.datadir import read_key_value
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    @dataclasses.dataclass
    class Flags(Config):
        spk2utt: str = ""

    flags, dev_flags = Flags(), DeviceFlags()
    args = parse_options(
        argv, [flags, dev_flags],
        "compute-cmvn-stats [--device=cuda] feats-rspec stats-wspec", 2, 2)
    device = resolve_device(dev_flags.device)
    spk_of = {}
    if flags.spk2utt:
        for spk, utts in read_key_value(flags.spk2utt).items():
            for u in utts.split():
                spk_of[u] = spk
    stats = {}
    for utt, mat in sequential_matrix_reader(args[0]):
        key = spk_of.get(utt, utt)
        stats[key] = acc_cmvn_stats(_on(mat, device), stats.get(key))
    with matrix_writer(args[1]) as w:
        for key in sorted(stats):
            w[key] = stats[key].cpu().numpy()
    return 0


def apply_cmvn_cli(argv) -> int:
    from kaldi_aslp_tpu_torch.feats.functions import apply_cmvn
    from kaldi_aslp_tpu_torch.io import (
        matrix_writer,
        random_access_matrix_reader,
        sequential_matrix_reader,
    )
    from kaldi_aslp_tpu_torch.io.datadir import read_key_value
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    @dataclasses.dataclass
    class Flags(Config):
        norm_vars: bool = False
        utt2spk: str = ""

    flags, dev_flags = Flags(), DeviceFlags()
    args = parse_options(
        argv, [flags, dev_flags],
        "apply-cmvn [--device=cuda] cmvn-rspec feats-rspec feats-wspec",
        3, 3)
    device = resolve_device(dev_flags.device)
    utt2spk = read_key_value(flags.utt2spk) if flags.utt2spk else {}
    cmvn = random_access_matrix_reader(args[0])
    with matrix_writer(args[2]) as w:
        for utt, mat in sequential_matrix_reader(args[1]):
            stats = torch.from_numpy(np.asarray(
                cmvn[utt2spk.get(utt, utt)], np.float64)).to(device)
            w[utt] = apply_cmvn(_on(mat, device), stats,
                                flags.norm_vars).cpu().numpy()
    return 0


def add_deltas_cli(argv) -> int:
    from kaldi_aslp_tpu_torch.feats.functions import (
        DeltaFeaturesOptions,
        add_deltas,
    )

    @dataclasses.dataclass
    class Flags(Config):
        delta_order: int = 2
        delta_window: int = 2

    flags = Flags()
    return _per_matrix(
        argv, [flags], "add-deltas [--device=cuda] in-rspec out-wspec",
        lambda m: add_deltas(m, DeltaFeaturesOptions(
            order=flags.delta_order, window=flags.delta_window)))


def splice_feats(argv) -> int:
    from kaldi_aslp_tpu_torch.feats.functions import splice_frames

    @dataclasses.dataclass
    class Flags(Config):
        left_context: int = 4
        right_context: int = 4

    flags = Flags()
    return _per_matrix(
        argv, [flags], "splice-feats [--device=cuda] in-rspec out-wspec",
        lambda m: splice_frames(m, flags.left_context, flags.right_context))


def feat_to_dim(argv) -> int:
    from kaldi_aslp_tpu_torch.io import sequential_matrix_reader
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    dev_flags = DeviceFlags()
    args = parse_options(argv, [dev_flags],
                         "feat-to-dim [--device=cuda] in-rspec [out]", 1, 2)
    device = resolve_device(dev_flags.device)
    for _, mat in sequential_matrix_reader(args[0]):
        print(_on(mat, device).shape[1])
        return 0
    return 1
