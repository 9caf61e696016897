"""Seconds the run's process spent building (nvcc) and loading the
kernels' libraries, from the program's counter
``ops/build.py:load_library.seconds``; a program without the counter
gives nothing."""

import importlib


def read(records):
    build = importlib.import_module("kaldi_aslp_tpu_torch.ops.build")
    return getattr(build.load_library, "seconds", None)
