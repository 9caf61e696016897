"""Lattice CLI mains.

Port of kaldi_aslp_tpu/cli/lat_tools.py (reference: src/latbin/
lattice-best-path.cc, lattice-scale.cc, lattice-copy.cc,
lattice-determinize.cc, lattice-lmrescore.cc; src/bin/
latgen-faster-mapped.cc; src/aslp-onlinebin/aslp-latgen-faster-rtf.cc):

    latgen-faster-mapped [--device=cuda] tid2pdf.txt HCLG.txt
        loglikes-rspec lattice-wspec [words-wspec]
    aslp-latgen-faster-rtf (the same, with real-time factors)
    lattice-copy | lattice-scale | lattice-determinize lats-rspec
        lats-wspec
    lattice-lmrescore clats-rspec G.txt clats-wspec
    lattice-best-path lats-rspec words-wspec [ali-wspec]

The lattice files are the JAX tools' bytes (io/lattice_io.py).  The two
decoding tools run the beam decoder on ``--device`` (default ``cuda``;
without CUDA they raise rather than run on the CPU); the others work on
the host.  Defaults are the JAX tools': acoustic scale 0.1, beam 16,
max-active 7000, lattice beam 8.  Where the JAX tools count every
``RuntimeError`` as a failed utterance, the port counts only the
decoder's "no path" error (``DecodeError``) and lets any other fault
end the run."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config, parse_options

LATGEN_USAGE = ("latgen-faster-mapped [--device=cuda] tid2pdf.txt "
                "HCLG.txt loglikes-rspec lattice-wspec [words-wspec]")


def lattice_best_path_cli(argv) -> int:
    """(reference: latbin/lattice-best-path.cc)."""
    @dataclasses.dataclass
    class Flags(Config):
        acoustic_scale: float = 1.0
        lm_scale: float = 1.0

    flags = Flags()
    args = parse_options(
        argv, [flags],
        "lattice-best-path lats-rspecifier transcription-wspecifier "
        "[ali-wspecifier]", 2, 3)
    from kaldi_aslp_tpu_torch.decoder import (
        CompactLattice,
        DecodeError,
        compact_lattice_best_path,
        state_lattice_best_path,
    )
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        sequential_lattice_reader,
    )

    n_done, n_fail = 0, 0
    tra = int_vector_writer(args[1])
    ali_w = int_vector_writer(args[2]) if len(args) > 2 else None
    for utt, lat in sequential_lattice_reader(args[0]):
        best_path = (compact_lattice_best_path
                     if isinstance(lat, CompactLattice)
                     else state_lattice_best_path)
        try:
            words, ali, _cost = best_path(lat, flags.lm_scale,
                                          flags.acoustic_scale)
        except DecodeError as e:
            print(f"lattice-best-path: {utt}: {e}", file=sys.stderr)
            n_fail += 1
            continue
        tra[utt] = words
        if ali_w is not None:
            ali_w[utt] = ali
        n_done += 1
    tra.close()
    if ali_w is not None:
        ali_w.close()
    print(f"Done {n_done} lattices, failed {n_fail}", file=sys.stderr)
    return 0 if n_done else 1


def lattice_scale_cli(argv) -> int:
    """(reference: latbin/lattice-scale.cc)."""
    @dataclasses.dataclass
    class Flags(Config):
        acoustic_scale: float = 1.0
        lm_scale: float = 1.0
        inv_acoustic_scale: float = 1.0

    flags = Flags()
    args = parse_options(
        argv, [flags], "lattice-scale lats-rspecifier lats-wspecifier",
        2, 2)
    from kaldi_aslp_tpu_torch.decoder import scale_lattice
    from kaldi_aslp_tpu_torch.io import (
        lattice_writer,
        sequential_lattice_reader,
    )

    acwt = flags.acoustic_scale
    if flags.inv_acoustic_scale != 1.0:
        if flags.acoustic_scale != 1.0:
            print("use only one of --acoustic-scale and "
                  "--inv-acoustic-scale", file=sys.stderr)
            return 1
        acwt = 1.0 / flags.inv_acoustic_scale
    n = 0
    with lattice_writer(args[1]) as w:
        for utt, lat in sequential_lattice_reader(args[0]):
            w[utt] = scale_lattice(lat, flags.lm_scale, acwt)
            n += 1
    print(f"Done {n} lattices", file=sys.stderr)
    return 0


def lattice_copy_cli(argv) -> int:
    """(reference: latbin/lattice-copy.cc); also the binary <-> text
    converter."""
    args = parse_options(
        argv, [], "lattice-copy lats-rspecifier lats-wspecifier", 2, 2)
    from kaldi_aslp_tpu_torch.io import (
        lattice_writer,
        sequential_lattice_reader,
    )

    n = 0
    with lattice_writer(args[1]) as w:
        for utt, lat in sequential_lattice_reader(args[0]):
            w[utt] = lat
            n += 1
    print(f"Copied {n} lattices", file=sys.stderr)
    return 0


def lattice_determinize_cli(argv) -> int:
    """(reference: latbin/lattice-determinize.cc; state lattices in,
    determinized compact lattices out)."""
    @dataclasses.dataclass
    class Flags(Config):
        beam: float = 0.0   # 0 = no pruning

    flags = Flags()
    args = parse_options(
        argv, [flags],
        "lattice-determinize lats-rspecifier clats-wspecifier", 2, 2)
    from kaldi_aslp_tpu_torch.decoder import (
        CompactLattice,
        determinize_lattice,
        state_to_lattice,
    )
    from kaldi_aslp_tpu_torch.io import (
        compact_lattice_writer,
        sequential_lattice_reader,
    )

    n = 0
    prune = flags.beam if flags.beam > 0 else None
    with compact_lattice_writer(args[1]) as w:
        for utt, lat in sequential_lattice_reader(args[0]):
            if isinstance(lat, CompactLattice):
                w[utt] = lat
            else:
                w[utt] = determinize_lattice(
                    state_to_lattice(lat), prune=prune)
            n += 1
    print(f"Determinized {n} lattices", file=sys.stderr)
    return 0


def latgen_faster_mapped_cli(argv, report_rtf: bool = False) -> int:
    """Beam-pruned lattice decode of loglike matrices (reference:
    src/bin/latgen-faster-mapped.cc:33-151; with report_rtf=True it is
    aslp-latgen-faster-rtf, src/aslp-onlinebin/
    aslp-latgen-faster-rtf.cc:131-144).

    The model argument is a tid -> pdf LUT text file (one int per line,
    index = transition id), as ali-to-pdf takes; the graph is the FST
    text format."""
    import time

    @dataclasses.dataclass
    class Flags(Config):
        acoustic_scale: float = 0.1
        beam: float = 16.0
        max_active: int = 7000
        lattice_beam: float = 8.0
        frame_shift: float = 0.01
        device: str = "cuda"

    flags = Flags()
    args = parse_options(argv, [flags], LATGEN_USAGE, 4, 5)
    from kaldi_aslp_tpu_torch.decoder import (
        BeamSearchDecoder,
        CsrGraph,
        DecodeError,
        PackedGraph,
        lattice_to_state,
    )
    from kaldi_aslp_tpu_torch.fst.fst import Fst
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        lattice_writer,
        sequential_matrix_reader,
    )

    lut = np.loadtxt(args[0], dtype=np.int64).reshape(-1)
    with open(args[1]) as f:
        fst = Fst.from_text(f.read())
    dec = BeamSearchDecoder(
        CsrGraph.from_packed(PackedGraph.from_fst(fst)), lut,
        acoustic_scale=flags.acoustic_scale, beam=flags.beam,
        max_active=int(flags.max_active), device=flags.device)
    words_w = int_vector_writer(args[4]) if len(args) > 4 else None
    n_done, n_fail = 0, 0
    tot_audio, tot_decode = 0.0, 0.0
    with lattice_writer(args[3]) as latw:
        for utt, ll in sequential_matrix_reader(args[2]):
            t0 = time.time()
            try:
                words, _ali, _score, lat = dec.decode_lattice(
                    np.asarray(ll, np.float32),
                    lattice_beam=flags.lattice_beam)
            except DecodeError as e:
                print(f"{utt}: decode failed: {e}", file=sys.stderr)
                n_fail += 1
                continue
            dt = time.time() - t0
            audio = len(ll) * flags.frame_shift
            tot_decode += dt
            tot_audio += audio
            if report_rtf:
                print(f"{utt} rtf {dt / max(audio, 1e-9):.4f} "
                      f"({dt:.2f}s / {audio:.2f}s)", file=sys.stderr)
            latw[utt] = lattice_to_state(lat)
            if words_w is not None:
                words_w[utt] = words
            n_done += 1
    if words_w is not None:
        words_w.close()
    if report_rtf and tot_audio > 0:
        print(f"TOTAL rtf {tot_decode / tot_audio:.4f} "
              f"({tot_decode:.2f}s / {tot_audio:.2f}s)", file=sys.stderr)
    print(f"Done {n_done} utterances, failed {n_fail}", file=sys.stderr)
    return 0 if n_done else 1


def latgen_faster_rtf_cli(argv) -> int:
    return latgen_faster_mapped_cli(argv, report_rtf=True)


def lattice_lmrescore_cli(argv) -> int:
    """(reference: latbin/lattice-lmrescore.cc: compose compact lattices
    with a word-level G, its costs scaled by --lm-scale; run once at -1
    with the old G and once at +1 with the new one)."""
    @dataclasses.dataclass
    class Flags(Config):
        lm_scale: float = 1.0

    flags = Flags()
    args = parse_options(
        argv, [flags],
        "lattice-lmrescore clats-rspecifier G.txt clats-wspecifier", 3, 3)
    from kaldi_aslp_tpu_torch.decoder import (
        CompactLattice,
        compact_lattice_lmrescore,
        determinize_lattice,
        state_to_lattice,
    )
    from kaldi_aslp_tpu_torch.fst.fst import Fst
    from kaldi_aslp_tpu_torch.io import (
        compact_lattice_writer,
        sequential_lattice_reader,
    )

    with open(args[1]) as f:
        G = Fst.from_text(f.read())
    n = 0
    with compact_lattice_writer(args[2]) as w:
        for utt, lat in sequential_lattice_reader(args[0]):
            if not isinstance(lat, CompactLattice):
                lat = determinize_lattice(state_to_lattice(lat))
            w[utt] = compact_lattice_lmrescore(
                lat, G, lm_scale=flags.lm_scale)
            n += 1
    print(f"Rescored {n} lattices", file=sys.stderr)
    return 0
