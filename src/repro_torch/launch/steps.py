"""Prefill and decode steps over a ModelBundle (PyTorch port of
``repro.launch.steps``; the train step waits for the training slice,
ROADMAP A5)."""
from __future__ import annotations

import torch

from repro_torch.models.model import ModelBundle


def make_prefill_step(bundle: ModelBundle):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return bundle.prefill_fn(params, batch)
    return prefill_step


def make_decode_step(bundle: ModelBundle):
    @torch.inference_mode()
    def decode_step(params, cache, batch):
        return bundle.decode_fn(params, cache, batch)
    return decode_step
