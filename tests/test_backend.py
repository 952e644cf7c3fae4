"""The backend resolver, the compile-cache helper, the Triton kernel's
dense-solve oracles and custom VJP, and the GPU-only entry points refusing
a CPU."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu.core import backend
from adi_thermal_fields_tpu.solvers import thomas_triton
from adi_thermal_fields_tpu.solvers.thomas import thomas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = dict(implementation="pallas", interpret=True)
SCAN = dict(implementation="xla")


def _dense(a, b, c, d):
    A = np.diag(b) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    return np.linalg.solve(A, d)


def _system(rng, n, batch):
    a = rng.normal(0, 1, (n,) + batch)
    c = rng.normal(0, 1, (n,) + batch)
    b = 4.0 + np.abs(a) + np.abs(c) + rng.random((n,) + batch)
    d = rng.normal(0, 1, (n,) + batch)
    return a, b, c, d


# --- resolver -------------------------------------------------------------

def test_resolver_auto_is_scan_on_cpu():
    assert backend.platform() == "cpu"
    assert backend.resolve_implementation("auto") == "xla"
    assert backend.resolve_implementation("xla") == "xla"
    assert backend.resolve_implementation("pallas", interpret=True) == "pallas"


def test_resolver_refuses_kernel_on_cpu_without_interpret():
    with pytest.raises(ValueError, match="interpret"):
        backend.resolve_implementation("pallas")
    with pytest.raises(ValueError, match="interpret"):
        thomas(*(jnp.ones((4, 3)),) * 4, implementation="pallas")


def test_resolver_refuses_unknown_implementation():
    with pytest.raises(ValueError, match="unknown implementation"):
        backend.resolve_implementation("mosaic")


def test_resolver_refuses_unknown_backend(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported"):
        backend.resolve_implementation("auto")


def test_resolver_auto_is_kernel_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.resolve_implementation("auto") == "pallas"
    assert backend.resolve_implementation("pallas") == "pallas"


# --- compile cache --------------------------------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert backend.compile_cache_dir() == tmp_path / "cc"


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert backend.compile_cache_dir() == \
        backend.Path(REPO).resolve() / ".jax_cache"


def test_configure_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    old = jax.config.jax_compilation_cache_dir
    try:
        path = backend.configure_compile_cache()
        assert path.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


# --- kernel oracles -------------------------------------------------------

@pytest.mark.parametrize("n", [3, 17, 100])
def test_kernel_matches_dense_at_odd_lengths(n):
    """Solve lengths with no power of two (the kernel loops over the solve
    axis) against dense solves."""
    rng = np.random.default_rng(n)
    a, b, c, d = _system(rng, n, (5,))
    x = np.asarray(thomas(*map(jnp.asarray, (a, b, c, d)), **KERNEL))
    for j in range(5):
        np.testing.assert_allclose(
            x[:, j], _dense(a[:, j], b[:, j], c[:, j], d[:, j]), rtol=1e-10)


@pytest.mark.parametrize("batch", [1, 15, 257, 300])
def test_kernel_ragged_batch_is_masked(batch, monkeypatch):
    """Batches that are no multiple of the block (16 here): the masked tail
    lanes neither corrupt live pencils nor go missing."""
    monkeypatch.setattr(thomas_triton, "BLOCK", 16)
    rng = np.random.default_rng(batch)
    a, b, c, d = _system(rng, 9, (batch,))
    x = np.asarray(thomas(*map(jnp.asarray, (a, b, c, d)), **KERNEL))
    ref = np.asarray(thomas(*map(jnp.asarray, (a, b, c, d)), **SCAN))
    np.testing.assert_allclose(x, ref, rtol=1e-12, atol=1e-12)
    j = batch - 1
    np.testing.assert_allclose(
        x[:, j], _dense(a[:, j], b[:, j], c[:, j], d[:, j]), rtol=1e-10)


@pytest.mark.parametrize("column", [False, True])
def test_kernel_vjp_matches_scan_autodiff(column):
    """The kernel's custom VJP (transposed solve) against jax.grad of the
    scan, w.r.t. all four operands; ``column``: a, b, c constant over the
    batch (their cotangents are summed over it)."""
    rng = np.random.default_rng(7)
    n, batch = 11, (4, 6)
    a, b, c, d = _system(rng, n, batch)
    if column:
        a, b, c = (v[:, :1, :1] for v in (a, b, c))
    args = tuple(map(jnp.asarray, (a, b, c, d)))
    w = jnp.asarray(rng.normal(size=(n,) + batch))

    def loss(a, b, c, d, tier):
        return jnp.sum(w * thomas(a, b, c, d, **tier) ** 2)

    g_s = jax.grad(loss, argnums=(0, 1, 2, 3))(*args, SCAN)
    g_k = jax.grad(loss, argnums=(0, 1, 2, 3))(*args, KERNEL)
    for gk, gs in zip(g_k, g_s):
        assert gk.shape == gs.shape
        np.testing.assert_allclose(np.asarray(gk), np.asarray(gs),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu_matches_scan():
    """The compiled Triton kernel (no interpreter) against the scan on the
    card, float32, at a batch with a ragged last block."""
    rng = np.random.default_rng(0)
    a, b, c, d = (jnp.asarray(v, jnp.float32)
                  for v in _system(rng, 129, (1000,)))
    x = thomas(a, b, c, d, implementation="pallas")
    ref = thomas(a, b, c, d, implementation="xla")
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


# --- GPU-only entry points ------------------------------------------------

def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def _assert_refused(proc):
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    if lines:
        with pytest.raises(ValueError):
            json.loads(lines[-1])


def test_chip_smoke_refuses_cpu(tmp_path):
    """No GPU: chip_smoke.py exits non-zero and prints no result line."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--workdir", str(tmp_path)],
        cwd=REPO, env=_cpu_env(), capture_output=True, text=True,
        timeout=300)
    _assert_refused(proc)
    assert "no GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the repository, the script cannot run."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    _assert_refused(proc)
