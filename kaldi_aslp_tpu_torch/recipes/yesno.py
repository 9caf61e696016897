"""The yesno end-to-end recipe (reference: egs/yesno/s5/run.sh).

Port of kaldi_aslp_tpu/recipes/yesno.py.  Full stage chain on disk
artifacts: corpus (synthesized: the openslr download needs network; the
reference audio is 8 kHz yes/no Hebrew recordings, stood in for by
tonal utterances of the same structure) → data dir → MFCC ark,scp +
CMVN → mono GMM-HMM flat-start training → graph from the task's ARPA
LM → beam-lattice decode → lattice ark → best path → WER.

The synthesis is the JAX module's numpy code, copied as it is, so both
packages write the same wave files.  What differs from the JAX recipe,
and why:
  - the features, the GMM and the decoder run on ``device`` (the card
    unless the caller asks for the CPU);
  - the reference task files (egs/yesno/s5/input/lexicon.txt and
    task.arpabo) are read from the reference checkout named by the
    ``KALDI_ASLP_REFERENCE`` environment variable when it holds them;
    the JAX recipe looks in one fixed directory.  Without them both fall
    back to the same built-in lexicon and LM.

Run: python -m kaldi_aslp_tpu_torch.recipes.yesno [workdir] [--device=cpu]
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.compact import (
    lattice_to_state,
    state_lattice_best_path,
)
from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph
from kaldi_aslp_tpu_torch.feats.functions import acc_cmvn_stats, apply_cmvn
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc, MfccOptions
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    arpa_to_fst,
    make_decode_graph,
)
from kaldi_aslp_tpu_torch.gmm.diag_gmm import gmm_loglikes
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.io import (
    DataDir,
    WaveData,
    lattice_writer,
    matrix_writer,
    read_wave,
    sequential_lattice_reader,
    sequential_matrix_reader,
    write_wave,
)
from kaldi_aslp_tpu_torch.ops.edit_distance import score_utterances
from kaldi_aslp_tpu_torch.utils.device import resolve_device
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("yesno")

SAMP_FREQ = 8000.0

# the reference task definition, consumed verbatim when present
# (reference: egs/yesno/s5/input/lexicon.txt, task.arpabo)
REFERENCE_ENV = "KALDI_ASLP_REFERENCE"
TASK_INPUT_SUBDIR = os.path.join("egs", "yesno", "s5", "input")
FALLBACK_LEXICON = "<SIL> SIL\nYES Y\nNO N\n"
FALLBACK_ARPA = """\
\\data\\
ngram 1=3

\\1-grams:
-1\tNO
-1\tYES
-99 <s>
-1 </s>

\\end\\
"""


def task_input_dir() -> str:
    """The reference checkout's yesno input directory, or "" when
    ``KALDI_ASLP_REFERENCE`` is unset."""
    root = os.environ.get(REFERENCE_ENV, "")
    return os.path.join(root, TASK_INPUT_SUBDIR) if root else ""


def load_task_inputs():
    """lexicon.txt + task.arpabo, preferring the reference's own files
    (reference: egs/yesno/s5/local/prepare_lm.sh consumes these)."""
    ref_dir = task_input_dir()
    lex_path = os.path.join(ref_dir, "lexicon.txt")
    arpa_path = os.path.join(ref_dir, "task.arpabo")
    lex_text = (open(lex_path).read() if ref_dir and os.path.exists(lex_path)
                else FALLBACK_LEXICON)
    arpa_text = (open(arpa_path).read()
                 if ref_dir and os.path.exists(arpa_path)
                 else FALLBACK_ARPA)
    return lex_text, arpa_text


# word → (fundamental Hz, formant Hz): distinct spectral shapes
WORD_TONES = {"YES": (220.0, 1400.0), "NO": (150.0, 700.0)}


def synthesize_corpus(wav_dir: str, num_utts: int = 60,
                      seed: int = 777):
    """Tonal yes/no utterances with silence gaps, 8 kHz like the
    original corpus."""
    rng = np.random.RandomState(seed)
    os.makedirs(wav_dir, exist_ok=True)
    texts: Dict[str, str] = {}
    for u in range(num_utts):
        words = ["YES" if rng.rand() < 0.5 else "NO" for _ in range(8)]
        key = "_".join("1" if w == "YES" else "0" for w in words)
        chunks = [np.zeros(int(0.25 * SAMP_FREQ))]
        for w in words:
            f0, f1 = WORD_TONES[w]
            dur = 0.25 + 0.1 * rng.rand()
            t = np.arange(int(dur * SAMP_FREQ)) / SAMP_FREQ
            env = np.hanning(len(t))
            sig = env * (4000 * np.sin(2 * np.pi * f0 * t)
                         + 2000 * np.sin(2 * np.pi * f1 * t))
            chunks.append(sig)
            chunks.append(np.zeros(int((0.15 + 0.1 * rng.rand())
                                       * SAMP_FREQ)))
        wave = np.concatenate(chunks) + 30 * rng.randn(
            sum(len(c) for c in chunks)
        )
        path = os.path.join(wav_dir, f"{key}_{u}.wav")
        write_wave(path, WaveData(SAMP_FREQ, wave[None, :].astype(
            np.float32)))
        texts[f"{key}_{u}"] = " ".join(words)
    return texts


def prepare_data(root: str, texts: Dict[str, str], wav_dir: str):
    """local/prepare_data.sh equivalent: train/test split + data dirs."""
    keys = sorted(texts)
    half = len(keys) // 2
    split = {"train_yesno": keys[:half], "test_yesno": keys[half:]}
    dirs = {}
    for name, utts in split.items():
        d = DataDir(path=os.path.join(root, "data", name))
        for k in utts:
            d.wav_scp[k] = os.path.join(wav_dir, f"{k}.wav")
            d.text[k] = texts[k]
            d.utt2spk[k] = "global"
        d.save()
        dirs[name] = d
    return dirs


def make_mfcc(root: str, d: DataDir, name: str,
              device: Union[str, torch.device] = "cuda") -> None:
    """steps/make_mfcc.sh + compute_cmvn_stats.sh equivalent: MFCCs on
    ``device`` into an ark,scp pair, the global CMVN stats as .npy."""
    mfcc_dir = os.path.join(root, "mfcc")
    os.makedirs(mfcc_dir, exist_ok=True)
    frame_opts = FrameExtractionOptions(samp_freq=SAMP_FREQ, dither=0.0)
    mfcc = Mfcc(frame_opts, MelBanksOptions(num_bins=23), MfccOptions(),
                device=device)
    stats = None
    ark = os.path.join(mfcc_dir, f"raw_mfcc_{name}.ark")
    scp = os.path.join(mfcc_dir, f"raw_mfcc_{name}.scp")
    with matrix_writer(f"ark,scp:{ark},{scp}") as w:
        for utt in sorted(d.wav_scp):
            wav = read_wave(d.wav_scp[utt])
            feats = mfcc(wav.data[0])
            w[utt] = feats.cpu().numpy()
            stats = acc_cmvn_stats(feats, stats)
    with open(scp) as f:
        d.feats_scp = dict(line.split(None, 1)
                           for line in f.read().splitlines())
    d.save()
    np.save(os.path.join(mfcc_dir, f"cmvn_{name}.npy"), stats.cpu().numpy())


def load_feats(root: str, d: DataDir, name: str) -> Dict[str, np.ndarray]:
    stats = torch.from_numpy(
        np.load(os.path.join(root, "mfcc", f"cmvn_{name}.npy")))
    scp = os.path.join(root, "mfcc", f"raw_mfcc_{name}.scp")
    return {utt: apply_cmvn(torch.from_numpy(feats), stats).numpy()
            for utt, feats in sequential_matrix_reader(f"scp:{scp}")}


def run(root: str = "exp_yesno", num_utts: int = 60,
        device: Union[str, torch.device] = "cuda") -> float:
    """Returns the test WER; the trained system stays in
    ``run.artifacts``."""
    t0 = time.time()
    dev = resolve_device(device)
    wav_dir = os.path.join(root, "waves_yesno")
    texts = synthesize_corpus(wav_dir, num_utts=num_utts)
    dirs = prepare_data(root, texts, wav_dir)
    logger.info("data prepared: %d train, %d test utts",
                len(dirs["train_yesno"].text), len(dirs["test_yesno"].text))

    for name, d in dirs.items():
        make_mfcc(root, d, name, dev)
    train_feats = load_feats(root, dirs["train_yesno"], "train_yesno")
    test_feats = load_feats(root, dirs["test_yesno"], "test_yesno")

    # lang prep from the reference task files (input/lexicon.txt +
    # task.arpabo consumed verbatim)
    lex_text, arpa_text = load_task_inputs()
    lang = Lang.build(Lexicon.from_text(lex_text))
    transcripts = {u: t.split() for u, t in
                   dirs["train_yesno"].text.items()}

    trainer = MonophoneTrainer(
        lang, opts=MonoTrainOptions(num_iters=12, totgauss=120,
                                    realign_iters="1 2 3 4 5 6 8 10"),
        device=dev)
    am, tm = trainer.train(train_feats, transcripts)
    logger.info("mono trained: %d pdfs, %d gaussians",
                am.num_pdfs, int(am.num_gauss_per_pdf.sum()))

    # graph from the reference ARPA LM + beam-pruned lattice decode
    # (decode.sh role: latgen → lattice ark → best-path → WER)
    G = arpa_to_fst(arpa_text, lang.words)
    hclg = make_decode_graph(lang, G, tm)
    packed = PackedGraph.from_fst(hclg)
    lut = tm.alignment_to_pdfs(np.arange(tm.num_transition_ids + 1))
    decoder = BeamSearchDecoder(
        CsrGraph.from_packed(packed), lut, acoustic_scale=1.0,
        beam=32.0, max_active=512, chunk=128, device=dev)
    am_packed = am.pack(dev)

    lat_path = os.path.join(root, "lat.ark")
    hyps, refs = {}, {}
    decode_time = 0.0
    audio_time = 0.0
    with lattice_writer(f"ark:{lat_path}") as latw:
        for utt, feats in test_feats.items():
            t1 = time.time()
            ll = gmm_loglikes(torch.from_numpy(feats).to(dev), *am_packed)
            _, _, _, lat = decoder.decode_lattice(ll, lattice_beam=8.0)
            decode_time += time.time() - t1
            audio_time += len(feats) * 0.01
            latw[utt] = lattice_to_state(lat)
            refs[utt] = dirs["test_yesno"].text[utt].split()
    # score from the on-disk lattices (score_basic.sh role)
    for utt, slat in sequential_lattice_reader(f"ark:{lat_path}"):
        words, _, _ = state_lattice_best_path(slat)
        hyps[utt] = [lang.words.sym(w) for w in words]
    stats = score_utterances(refs, hyps)
    rtf = decode_time / max(audio_time, 1e-9)
    logger.info("%s", stats.report())
    logger.info("decode RTF %.4f; total pipeline %.1fs",
                rtf, time.time() - t0)
    print(stats.report())
    print(f"RTF {rtf:.4f}")
    run.artifacts = dict(dirs=dirs, lang=lang, trainer=trainer, am=am,
                         tm=tm, hclg=hclg, train_feats=train_feats,
                         test_feats=test_feats, transcripts=transcripts,
                         hyps=hyps, rtf=rtf, stats=stats)
    return stats.wer


def main(argv: List[str]) -> int:
    args = [a for a in argv if not a.startswith("--")]
    device = "cuda"
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
    wer = run(args[0] if args else "exp_yesno", device=device)
    return 0 if wer < 5.0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
