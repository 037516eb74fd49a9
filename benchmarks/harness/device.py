"""The card, and the few calls that mean nothing on a CPU (where the tests
drive the rest of a run)."""

from __future__ import annotations

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
