"""The command line the examples share: ``[outdir] [--cpu]``."""

from __future__ import annotations

import argparse


def parser(doc: str, outdir: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    if outdir:
        p.add_argument("outdir", nargs="?", default="example_out")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    return p


def device_of(args) -> str:
    return "cpu" if args.cpu else "cuda"
