"""The program's network for a configuration, from the module of its
architecture (``portbench/architectures/<architecture>.py``), found by
the name the configuration's file gives."""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

import torch

from portbench.harness.cells import check_name


def architecture(cfg: dict) -> ModuleType:
    return importlib.import_module(
        f"portbench.architectures.{check_name(cfg['architecture'])}")


def port_name(cfg: dict, leaf: str) -> str:
    return architecture(cfg).port_name(cfg, leaf)


def build(cfg: dict, weights: Dict[str, torch.Tensor], device):
    return architecture(cfg).build(cfg, weights, device)
