"""The port's exact-log2 correction (megalania_tpu_torch/ops/log2_cuda.py)
against megalania_tpu's pallas_repair2.log2_correction (its Pallas probe
in interpret mode) and the numpy oracle build_correction, tolerance 0.
The plain version stands in for the kernel on the CPU; the kernel itself
is held against it in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from megalania_tpu.ops import pallas_repair2
from megalania_tpu_torch.anneal import engine
from megalania_tpu_torch.anneal.config import AnnealConfig
from megalania_tpu_torch.ops import log2_cuda, tables as TT

EXACT = torch.as_tensor(TT.LOG2_TABLE_I32)
DATA = (b"abra cadabra abra cadabra! abracadabra? "
        b"the rain in spain falls mainly on the plain. " * 3)[:192]


def _raw(kind: str) -> np.ndarray:
    """int32[2048] raw float32 costs of p = max(i, 1) from one path."""
    if kind == "jax":           # the reference's own float32 sequence
        return np.array(pallas_repair2._f32_log2_cost(
            jnp.maximum(jnp.arange(2048, dtype=jnp.int32), 1)))
    if kind == "numpy":         # another float32 path
        x = np.maximum(np.arange(2048), 1).astype(np.float32) * np.float32(
            1 / 2048)
        return np.trunc(-np.log2(x) * np.float32(2048)).astype(np.int32)
    if kind == "plain":         # the probe's plain version: the table
        return log2_cuda.log2_probe_plain("cpu").numpy()
    # every code, the top bit of a word included: the table off by a
    # seeded -1, 0 or +1 at each p
    exact = log2_cuda.log2_probe_plain("cpu").numpy()
    d = np.random.default_rng(2048).integers(-1, 2, 2048)
    return (exact - d).astype(np.int32)


@pytest.mark.parametrize("kind", ["jax", "numpy", "plain", "random"])
def test_plain_correction_is_exact(kind):
    """correction_plain gives build_correction's words, and raw + words is
    the exact table for p in 1..2047; on the reference's float32 path the
    words are the reference's own, on the table itself all codes 0."""
    raw = _raw(kind)
    corr = log2_cuda.correction_plain(torch.as_tensor(raw), EXACT)
    assert corr.dtype == torch.int32 and tuple(corr.shape) == (128,)
    np.testing.assert_array_equal(corr.numpy(),
                                  log2_cuda.build_correction(raw))
    np.testing.assert_array_equal(
        log2_cuda.apply_correction(raw, corr.numpy())[1:],
        TT.LOG2_TABLE_NP[1:])
    if kind == "jax":
        np.testing.assert_array_equal(
            corr.numpy(),
            np.asarray(pallas_repair2.log2_correction(interpret=True))[0])
    if kind == "plain":
        assert (corr == 0x55555555).all()
    if kind == "random":
        assert (corr < 0).any()             # a word with its top bit set


@pytest.mark.parametrize("delta", [2, -2])
@pytest.mark.parametrize("impl", ["plain", "numpy"])
def test_deviation_beyond_one_raises(impl, delta):
    """A raw off the table by 2 at one p raises the reference's error."""
    raw = _raw("jax").astype(np.int32)
    p = 1 + int(np.flatnonzero(TT.LOG2_TABLE_NP[1:] == raw[1:])[700])
    raw[p] += delta
    with pytest.raises(RuntimeError, match="deviates by >1"):
        if impl == "plain":
            log2_cuda.correction_plain(torch.as_tensor(raw), EXACT)
        else:
            log2_cuda.build_correction(raw)


@pytest.mark.parametrize("lc", [0, 3])
def test_context_corr_is_the_plain_version(lc):
    """A CPU block context carries the plain version's words; the
    kernel's wrapper takes no CPU tensor (no fallback)."""
    ctx = engine.make_context(DATA, AnnealConfig(chains=2, lc=lc), "cpu")
    want = log2_cuda.correction_plain(log2_cuda.log2_probe_plain("cpu"),
                                      EXACT)
    assert torch.equal(ctx.corr, want)
    assert torch.equal(log2_cuda.log2_correction(ctx.log2), want)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        log2_cuda.log2_correction_cuda(ctx.log2)
