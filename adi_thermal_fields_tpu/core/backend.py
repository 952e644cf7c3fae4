"""Backend resolution and the persistent compile cache.

The one place that asks JAX which platform it runs on.  Every solver tier
choice goes through :func:`resolve_implementation`:

* ``"xla"``: the ``lax.scan`` Thomas tier (any platform; the reference the
  kernels are tested against).
* ``"pallas"``: the Pallas-Triton tridiagonal kernel
  (solvers/thomas_triton.py).  Compiles for NVIDIA GPUs; on the CPU it runs
  only in the Pallas interpreter, and only when ``interpret=True`` is asked
  for explicitly.
* ``"auto"``: the kernel on ``gpu``, the scan on ``cpu``.

A platform this module does not know raises instead of guessing.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["platform", "resolve_implementation", "configure_compile_cache",
           "compile_cache_dir"]

_KNOWN = ("cpu", "gpu")
_IMPLEMENTATIONS = ("auto", "pallas", "xla")


def platform() -> str:
    """The default backend's platform name ("cpu" or "gpu"); raises on any
    other platform."""
    name = jax.default_backend()
    if name not in _KNOWN:
        raise RuntimeError(f"unsupported JAX backend {name!r}: this package "
                           f"runs on {_KNOWN}")
    return name


def resolve_implementation(implementation: str = "auto",
                           interpret: bool = False) -> str:
    """Map a requested solver tier to "pallas" or "xla" (module docstring).

    Raises ``ValueError`` for an unknown tier, and for ``"pallas"`` on the
    CPU without ``interpret=True`` (the kernel has no CPU compilation)."""
    if implementation not in _IMPLEMENTATIONS:
        raise ValueError(f"unknown implementation {implementation!r}; "
                         f"expected one of {_IMPLEMENTATIONS}")
    plat = platform()
    if implementation == "auto":
        return "pallas" if plat == "gpu" else "xla"
    if implementation == "pallas" and plat == "cpu" and not interpret:
        raise ValueError("implementation='pallas' on the CPU needs "
                         "interpret=True (the Triton kernel compiles only "
                         "for a GPU)")
    return implementation


def compile_cache_dir() -> Path:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` at the
    root of the checkout (a fixed path: the cache key includes it)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return that directory.  Call once at program start, before the
    first compilation."""
    path = compile_cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    return path
