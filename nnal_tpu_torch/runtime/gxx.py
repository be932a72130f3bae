"""Host C++ libraries of the port, built with ``g++`` on first use into
the git-ignored ``nnal_tpu_torch/_build/`` and named by the hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads as is (the scheme of ``ops/_build``)."""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

from nnal_tpu_torch.ops._build import BUILD_DIR


def library_path(src: str, flags, stem: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()
                                + " ".join(flags).encode()).hexdigest()
    return str(BUILD_DIR / f"{stem}-{digest[:16]}.so")


def build_library(src: str, flags, stem: str) -> str:
    """The path of ``src`` built with ``g++ flags``, building it unless it
    is there; ``RuntimeError`` with the compiler's message when ``g++``
    fails or is missing."""
    out = library_path(src, flags, stem)
    if os.path.exists(out):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, "-o", tmp, src], check=True,
                       capture_output=True, text=True)
    except (FileNotFoundError, subprocess.CalledProcessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"native {stem}: g++ failed: "
                           f"{getattr(e, 'stderr', None) or e}") from e
    os.replace(tmp, out)
    return out
