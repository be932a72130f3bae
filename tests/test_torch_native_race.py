"""The port tests' guard against the JAX package's native-build race
(``tests/torch_jax_native.ensure_jax_native``).

* A JAX native module left in the state a lost race leaves it in
  (``_lib`` None, ``_build_failed`` True) is loaded again by
  ``ensure_jax_native``.  The module's ``_SO`` points into ``tmp_path``,
  so the JAX module's own rebuild writes there.
* A library that cannot load (``_SO`` a garbage file newer than its
  source, so the JAX module never rebuilds it) makes ``ensure_jax_native``
  raise, naming the library, within its deadline; it does not skip.
* Neither writes anything under ``nnal_tpu/`` (its sources, Python files
  and everything else but the JAX package's own ``.so`` builds and
  ``__pycache__``, which other test processes may write meanwhile).
"""

import importlib
import os
import time

import pytest
import torch

from torch_jax_native import LIBRARIES, ensure_jax_native

torch.set_num_threads(1)

JAX_PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "nnal_tpu")


def _tree_state():
    """(path, size, mtime) of every file under ``nnal_tpu/`` but the
    native builds and bytecode caches."""
    out = []
    for root, dirs, files in os.walk(JAX_PKG):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".so"):
                continue
            p = os.path.join(root, f)
            st = os.stat(p)
            out.append((p, st.st_size, st.st_mtime_ns))
    return sorted(out)


def _module(name):
    return importlib.import_module(LIBRARIES[name][0])


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_failed_load_is_retried_until_loaded(name, tmp_path, monkeypatch):
    mod = _module(name)
    before = _tree_state()
    so = str(tmp_path / os.path.basename(mod._SO))
    monkeypatch.setattr(mod, "_SO", so)
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(mod, "_build_failed", True)
    probe = getattr(mod, LIBRARIES[name][1])
    assert not probe()            # the lost race's state sticks
    ensure_jax_native(name, deadline=60.0, pause=0.2)
    assert mod._lib is not None and not mod._build_failed
    assert mod._lib._name == so and os.path.getsize(so) > 0
    assert probe()
    assert _tree_state() == before


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_unloadable_library_raises_naming_it(name, tmp_path, monkeypatch):
    mod = _module(name)
    before = _tree_state()
    so = tmp_path / os.path.basename(mod._SO)
    so.write_bytes(b"not an ELF shared object\n" * 64)
    newer = os.path.getmtime(mod._SRC) + 3600
    os.utime(so, (newer, newer))
    monkeypatch.setattr(mod, "_SO", str(so))
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(mod, "_build_failed", False)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=f"native {name} library"):
        ensure_jax_native(name, deadline=1.5, pause=0.25)
    assert time.monotonic() - t0 < 10.0
    assert mod._lib is None
    assert so.read_bytes().startswith(b"not an ELF")   # never rebuilt
    assert _tree_state() == before
