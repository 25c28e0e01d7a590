"""What the port's tools share: the `--device` flag that every device tool
takes (the card by default, the CPU only when the caller asks for it), the
repo's root and a device sync for timing."""

from __future__ import annotations

import argparse
import os

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NO_CARD = "no CUDA device is available; pass --device cpu to run on the CPU"


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; stops without a card) or cpu")


def device_of(ap: argparse.ArgumentParser, args) -> torch.device:
    """`args.device`, or the parser's error when it names the card and
    there is none (never a silent fall back to the CPU)."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error(NO_CARD)
    return dev


def check_device(device) -> torch.device:
    """`device` as a torch device; raises when it names the card and there
    is none (for the tools' functions called from Python)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CARD.replace("--device cpu", 'device="cpu"'))
    return dev


def sync(*devices) -> None:
    """Wait for the work queued on each card among `devices`."""
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
