"""Pitch and spectrum CLI tools (reference:
src/featbin/compute-kaldi-pitch-feats,
src/aslp-vadbin/aslp-compute-spectrum-feats.cc).

Port of two tools of kaldi_aslp_tpu/cli/vad_tools.py; the VAD tools of
that file are not ported yet.  Both take ``--device`` (default ``cuda``)
and compute there.  ``aslp-compute-spectrum-feats`` refuses
``--dither`` other than 0, as the feature tools do (cli/feat_tools.py):
the JAX tool takes the flag, default 1.0, and never dithers."""

from __future__ import annotations

import dataclasses

from kaldi_aslp_tpu_torch.cli.feat_tools import (
    DeviceFlags,
    iter_wavs,
    refuse_dither,
)
from kaldi_aslp_tpu_torch.utils.config import Config, parse_options


def compute_pitch_cli(argv) -> int:
    from kaldi_aslp_tpu_torch.feats.pitch import (
        PitchOptions,
        compute_pitch,
        postprocess_pitch,
    )
    from kaldi_aslp_tpu_torch.io import matrix_writer
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    popts = PitchOptions()

    @dataclasses.dataclass
    class Flags(Config):
        post_process: bool = True

    flags, dev_flags = Flags(), DeviceFlags()
    args = parse_options(
        argv, [popts, flags, dev_flags],
        "compute-kaldi-pitch-feats [--device=cuda] scp:wav.scp "
        "ark:pitch.ark", 2, 2)
    device = resolve_device(dev_flags.device)
    with matrix_writer(args[1]) as w:
        for utt, wav in iter_wavs(args[0]):
            popts.samp_freq = wav.samp_freq
            raw = compute_pitch(wav.data[0], popts, device=device)
            w[utt] = postprocess_pitch(raw) if flags.post_process else raw
    return 0


def compute_spectrum_feats(argv) -> int:
    """Log power spectrogram features (reference:
    aslp-vadbin/aslp-compute-spectrum-feats.cc,
    aslp-vad/feature-spectrum.*)."""
    from kaldi_aslp_tpu_torch.feats.plp import Spectrogram
    from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
    from kaldi_aslp_tpu_torch.io import matrix_writer
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    tool = "aslp-compute-spectrum-feats"
    fo, dev_flags = FrameExtractionOptions(dither=0.0), DeviceFlags()
    args = parse_options(
        argv, [fo, dev_flags],
        f"{tool} [--device=cuda] scp:wav.scp ark:feats.ark", 2, 2)
    refuse_dither(tool, fo.dither)
    device = resolve_device(dev_flags.device)
    spec = None
    with matrix_writer(args[1]) as w:
        for utt, wav in iter_wavs(args[0]):
            if spec is None:
                fo.samp_freq = wav.samp_freq
                spec = Spectrogram(fo, device=device)
            w[utt] = spec(wav.data[0]).cpu().numpy()
    return 0
