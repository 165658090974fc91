"""The torch device of an entry point.

Entry points (`cli`, Database, MatchGraphBuilder, IncrementalSfM,
DenseReconstruction) run on the card unless the caller passes the CPU, and
refuse a CUDA device when no card is present: nothing quietly runs on the
CPU instead.
"""
from __future__ import annotations

import torch


def resolve(device="cuda", what: str = "device") -> torch.device:
    """torch.device(device); raises RuntimeError for a CUDA device when
    torch sees no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} {device}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return dev
