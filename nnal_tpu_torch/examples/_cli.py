"""The examples' shared command-line pieces."""

from __future__ import annotations

import argparse
import os
import tempfile


def parser(name: str, root: bool = True) -> argparse.ArgumentParser:
    """An argument parser with ``root_dir`` (default: a directory named
    after the example under the temp directory), ``--tiny`` and
    ``--device`` (default: the card)."""
    ap = argparse.ArgumentParser(prog=f"python -m nnal_tpu_torch.examples."
                                      f"{name}")
    if root:
        ap.add_argument("root_dir", nargs="?", default=os.path.join(
            tempfile.gettempdir(), f"nnal_torch_{name}"))
    ap.add_argument("--tiny", action="store_true",
                    help="the seconds-scale settings")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def rounded(values) -> list:
    return [round(float(v), 3) for v in values]
