#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kaldi_aslp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits nonzero:
  1. device   - fail without CUDA; print the card, its power limit and
                the torch / CUDA versions;
  2. build    - compile the LSTMP kernel from csrc/ with nvcc (sm_90a);
  3. kernel   - hold the kernel against its plain PyTorch version on the
                card at the flagship's widths (C=512, P=320) and the
                shapes of the served path and of a training batch, and
                time both with CUDA events;
  4. slice    - serve the flagship BLSTM-CTC (3 x BLSTMP, C=512, P=320,
                40 fbank inputs, 72 CTC targets; random weights from a
                numpy seed) through the port's online server, built by its
                CLI session factory with --device=cuda: 2 requests one
                after the other, then 2 at the same time; each must give
                partial events and one final event, and every chunk's
                network forward must have launched the kernel 6 times
                (3 layers x 2 directions);
  5. check    - one request's per-chunk acoustic scores from the card
                against the port on the CPU (plain versions).
The last lines are the kernels' JSON record, the card's name and power
limit as nvidia-smi prints them, and the result line.

Imports nothing of JAX; from kaldi_aslp_tpu it uses only the numpy
graph builders in kaldi_aslp_tpu.fst."""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)   # float32 both sides, summation
#                                          order differs, contractive cell
CROSS_CHECK_ATOL = 1e-3                    # log-domain scores, card vs CPU
KERNEL_SHAPES = [(1, 16, 40), (1, 16, 640), (8, 200, 640), (128, 400, 640)]
C, P, FEAT_DIM, TARGETS, LAYERS = 512, 320, 40, 72, 3
SAMPLE_RATE = 16000
CHUNK_BYTES = 2 * SAMPLE_RATE // 4        # 250 ms of int16 PCM


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def uniform(rs, *shape, scale=0.1):
    """The LSTMP init distribution (uniform in [-param_scale, param_scale],
    kaldi_aslp_tpu/models/recurrent.py:init_params)."""
    return (scale * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# -- phase 3 -----------------------------------------------------------------

def kernel_phase(dev):
    from kaldi_aslp_tpu_torch.ops.lstmp import (
        lstmp_forward,
        lstmp_forward_reference,
    )

    results = []
    for S, T, D in KERNEL_SHAPES:
        rs = np.random.RandomState(S * 1000 + T + D)

        def t(a):
            return torch.from_numpy(a).to(dev)
        x = t(rs.randn(S, T, D).astype(np.float32))
        w_x, bias = t(uniform(rs, 4 * C, D)), t(uniform(rs, 4 * C))
        xg = (torch.matmul(x, w_x.t()) + bias).contiguous()
        lens = np.full(S, T)
        if S > 1:
            lens = rs.randint(T // 4, T + 1, size=S)
            lens[0] = T
        mask = t((np.arange(T)[None, :] < lens[:, None]).astype(np.float32))
        args = (xg, mask, t(uniform(rs, 4 * C, P)), t(uniform(rs, P, C)),
                t(uniform(rs, 3, C)), t(uniform(rs, S, C, scale=0.5)),
                t(uniform(rs, S, P, scale=0.5)))
        got = lstmp_forward(*args)
        want = lstmp_forward_reference(*args)
        torch.cuda.synchronize()
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        for name, g, w in zip(("ys", "c_T", "r_T"), got, want):
            if not torch.isfinite(g).all():
                raise RuntimeError(f"kernel {name} not finite at {S, T, D}")
            torch.testing.assert_close(g, w, **KERNEL_TOL)
        reps = 20 if T <= 16 else 5
        ms = cuda_ms(lambda: lstmp_forward(*args), reps)
        plain_ms = cuda_ms(lambda: lstmp_forward_reference(*args),
                           max(reps // 4, 3))
        results.append({"S": S, "T": T, "D": D, "max_abs_err": max(errs),
                        "ms": ms, "plain_ms": plain_ms})
        log("kernel", name="lstmp_forward", S=S, T=T, D=D, C=C, P=P,
            err_ys=errs[0], err_c=errs[1], err_r=errs[2], tol=KERNEL_TOL,
            ms=ms, plain_ms=plain_ms)
    return results


# -- phase 4 -----------------------------------------------------------------

def write_model_and_graph(workdir: str):
    """Flagship zip (port's Nnet.save, JAX zip format), tid2pdf LUT, a
    CTC TLG over 71 phones + blank and 200 words, and the word table."""
    from kaldi_aslp_tpu.fst import Lang, Lexicon, make_unigram_grammar
    from kaldi_aslp_tpu.fst.ctc_graph import ctc_lut, make_ctc_decode_graph
    from kaldi_aslp_tpu_torch.models.flagship import build_blstm_ctc
    from kaldi_aslp_tpu_torch.models.interop import params_from_jax

    rs = np.random.RandomState(1234)
    net = build_blstm_ctc(FEAT_DIM, LAYERS, P, C, TARGETS)
    tree = {}
    for name, p in net.state_dict().items():
        node = tree
        for part in name.split(".")[1:-1]:
            node = node.setdefault(part, {})
        if name.endswith(".w"):        # the output layer's gaussian init
            node["w"] = (0.04 * rs.randn(*p.shape)).astype(np.float32)
        elif name.endswith(".b"):
            node["b"] = np.zeros(p.shape, np.float32)
        else:
            node[name.rsplit(".", 1)[1]] = uniform(rs, *p.shape)
    net.load_state_dict(params_from_jax(tree))
    paths = [f"{workdir}/{n}" for n in
             ("flagship.zip", "tid2pdf.txt", "TLG.txt", "words.txt")]
    net.save(paths[0])

    phones = [f"P{i:02d}" for i in range(70)]     # + SIL = 71 phones
    words = {f"W{i:03d}": " ".join(rs.choice(phones, rs.randint(2, 6)))
             for i in range(200)}
    lex = "\n".join(f"{w} {p}" for w, p in words.items()) + "\n<SIL> SIL\n"
    lang = Lang.build(Lexicon.from_text(lex))
    if len(lang.phones) != TARGETS:
        raise RuntimeError(f"{len(lang.phones)} CTC outputs, want {TARGETS}")
    t0 = time.perf_counter()
    tlg = make_ctc_decode_graph(
        lang, make_unigram_grammar({w: 1 / len(words) for w in words},
                                   lang.words))
    log("graph", states=tlg.num_states, arcs=tlg.num_arcs,
        build_s=time.perf_counter() - t0)
    np.savetxt(paths[1], ctc_lut(TARGETS), fmt="%d")
    with open(paths[2], "w") as f:
        f.write(tlg.to_text())
    with open(paths[3], "w") as f:
        f.write(lang.words.to_text())
    return paths


def synth_pcm(seed: int, seconds: float) -> bytes:
    """Speech-like int16 PCM: voiced bursts of harmonics over noise,
    separated by short pauses."""
    rs = np.random.RandomState(seed)
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    f0 = 110 + 40 * np.sin(2 * np.pi * 0.7 * t + rs.rand() * 6)
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
    envelope = (np.sin(2 * np.pi * 2.5 * t + rs.rand() * 6) > -0.3)
    wave = 3000 * voiced * envelope + 200 * rs.randn(n)
    return np.clip(wave, -32768, 32767).astype("<i2").tobytes()


async def request(port: int, pcm: bytes) -> dict:
    """Send ``pcm`` in 250 ms chunks while reading events; time the final
    event from the last byte sent."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    events = []
    t_first = time.perf_counter()
    t_last_byte = None

    async def pump():
        nonlocal t_last_byte
        for i in range(0, len(pcm), CHUNK_BYTES):
            writer.write(pcm[i:i + CHUNK_BYTES])
            await writer.drain()
        writer.write_eof()
        t_last_byte = time.perf_counter()

    async def results():
        async for line in reader:
            events.append((time.perf_counter(), json.loads(line)))

    await asyncio.gather(pump(), results())
    writer.close()
    await writer.wait_closed()
    types = [e["type"] for _, e in events]
    if "partial" not in types or types.count("final") != 1 \
            or types[-1] != "final":
        raise RuntimeError(f"bad event sequence {types}")
    t_final = events[-1][0]
    audio_s = len(pcm) / 2 / SAMPLE_RATE
    return {"audio_s": audio_s, "partials": types.count("partial"),
            "final_text_words": len(events[-1][1]["text"].split()),
            "latency_ms_last_byte_to_final": 1e3 * (t_final - t_last_byte),
            "audio_s_per_s": audio_s / (t_final - t_first)}


def slice_phase(paths, device: str):
    from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv
    from kaldi_aslp_tpu_torch.online.server import (
        OnlineServerOptions,
        OnlineTcpServer,
    )
    from kaldi_aslp_tpu_torch.ops.lstmp import lstmp_forward

    factory = session_factory_from_argv(
        [f"--device={device}", f"--num-mel-bins={FEAT_DIM}", *paths])
    bad = [n for n, p in factory.net.state_dict().items()
           if p.device.type != device]
    if bad:
        raise RuntimeError(f"model tensors not on {device}: {bad}")
    calls = []
    recorded = []   # (frames, scores) of every chunk of the first session

    def make_session():
        session = factory()
        index = len(calls)
        calls.append(0)
        inner = session.acoustic_fn

        def acoustic_fn(frames):
            scores = inner(frames)
            calls[index] += 1
            if index == 0:
                recorded.append((np.array(frames), np.array(scores)))
            if scores.shape != (len(frames), TARGETS) \
                    or not np.isfinite(scores).all():
                raise RuntimeError(f"bad acoustic scores {scores.shape}")
            return scores
        session.acoustic_fn = acoustic_fn
        return session

    pcms = [synth_pcm(i, 3.0 + 0.25 * i) for i in range(4)]

    async def serve():
        server = OnlineTcpServer(make_session, OnlineServerOptions(port=0))
        port = await server.start()
        try:
            out = [await request(port, pcms[0]), await request(port, pcms[1])]
            t0 = time.perf_counter()
            out += await asyncio.gather(request(port, pcms[2]),
                                        request(port, pcms[3]))
            concurrent_s = time.perf_counter() - t0
            return out, concurrent_s
        finally:
            await server.stop()

    lstmp_forward.launches = 0
    stats, concurrent_s = asyncio.run(serve())
    launches = lstmp_forward.launches
    for i, st in enumerate(stats):
        log("request", index=i, concurrent=i >= 2, acoustic_fn_calls=calls[i],
            **st)
    if launches != 2 * LAYERS * sum(calls) or launches == 0:
        raise RuntimeError(
            f"{launches} LSTMP launches for {sum(calls)} acoustic_fn calls")
    log("slice", requests=len(stats), acoustic_fn_calls=sum(calls),
        lstmp_launches=launches,
        concurrent_pair_audio_s_per_s=(
            (stats[2]["audio_s"] + stats[3]["audio_s"]) / concurrent_s))
    return launches, recorded


# -- phase 5 -----------------------------------------------------------------

def cross_check(paths, recorded):
    from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv

    cpu = session_factory_from_argv(
        ["--device=cpu", f"--num-mel-bins={FEAT_DIM}", *paths])
    worst = 0.0
    for frames, scores in recorded:
        worst = max(worst, float(np.abs(cpu.acoustic_fn(frames)
                                        - scores).max()))
    log("cross_check", chunks=len(recorded), max_abs_err=worst,
        atol=CROSS_CHECK_ATOL)
    if not recorded or worst > CROSS_CHECK_ATOL:
        raise RuntimeError(f"card vs CPU scores differ by {worst}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = smi_name_and_power()
    print(smi, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 reference
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from kaldi_aslp_tpu_torch.ops import build, lstmp

    t0 = time.perf_counter()
    lstmp.build()
    log("build", kernel="lstmp_forward", seconds=time.perf_counter() - t0,
        library=str(build.library_path(lstmp.SOURCE).name))

    kernel_results = kernel_phase(dev)
    with tempfile.TemporaryDirectory() as workdir:
        paths = write_model_and_graph(workdir)
        launches, recorded = slice_phase(paths, "cuda")
        cross_check(paths, recorded)

    served = next(r for r in kernel_results if (r["S"], r["T"]) == (1, 16)
                  and r["D"] == 2 * P)
    print(json.dumps({"kernels": [{
        "name": "lstmp_forward", "route": "cuda",
        "source": "kaldi_aslp_tpu_torch/csrc/lstmp_forward.cu",
        "replaces": "kaldi_aslp_tpu/ops/lstm_pallas.py:43",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_results),
        "ms": served["ms"], "plain_ms": served["plain_ms"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
