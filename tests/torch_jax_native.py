"""Load the JAX package's native host libraries before a port test holds
the port against them.

The JAX package builds ``runtime/dense_crf.cc``, ``slic.cc`` and
``patch_gather.cc`` lazily with ``g++ -o`` straight into the final
``.so`` path, and one failed load sets its module's ``_build_failed``
for the life of the process.  Under ``pytest -n 6 --dist loadfile`` a
worker that loads while another worker is still writing the library
gets an ``OSError`` and never tries again; the JAX package then falls
back quietly (the mean-field CRF for 2-D, numpy for SLIC and the gather)
or raises (the 3-D CRF).  A port test that compared against that would
compare against another solver, or fail for a reason that is not the
port's.

:func:`ensure_jax_native` is called once per test module, from a module
fixture, before the JAX side runs: it asks the JAX module's
``*_available()``, and on failure clears the module's ``_lib`` /
``_build_failed``, waits and asks again, up to a deadline.  Past the
deadline it raises naming the library; it never skips.  It writes
nothing itself: a rebuild, if one happens, is the JAX module's own.
"""

import ctypes
import importlib
import time

# name -> (JAX module, its availability probe)
LIBRARIES = {
    "crf": ("nnal_tpu.runtime.crf_native", "crf_native_available"),
    "slic": ("nnal_tpu.runtime.slic_native", "slic_native_available"),
    "gather": ("nnal_tpu.runtime.native", "native_available"),
}


def _load_error(path: str) -> str:
    try:
        ctypes.CDLL(path)
    except OSError as e:
        return str(e)
    return "it loads now"


def ensure_jax_native(*names, deadline: float = 120.0,
                      pause: float = 1.0) -> None:
    """Make each named JAX native library (``crf``, ``slic``,
    ``gather``) loaded in this process, retrying every ``pause`` seconds
    until ``deadline`` seconds have passed; then raise ``RuntimeError``
    naming the library."""
    for name in names:
        modname, probe = LIBRARIES[name]
        mod = importlib.import_module(modname)
        end = time.monotonic() + deadline
        while not getattr(mod, probe)():
            if time.monotonic() >= end:
                raise RuntimeError(
                    f"the JAX package's native {name} library ({mod._SO}) "
                    f"did not load within {deadline:g} s: "
                    f"{_load_error(mod._SO)}")
            time.sleep(pause)
            with mod._lock:
                mod._lib = None
                mod._build_failed = False
