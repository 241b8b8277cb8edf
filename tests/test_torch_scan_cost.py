"""megalania_tpu_torch.ops.scan_cost against megalania_tpu's parse_cost_jit
and the pure-Python oracle (pyemit.parse_cost): exact cost, final
probabilities and live mask of random valid parses, at lc 0 and 3, for
one parse and over a chain axis."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from megalania_tpu.ops import scan_cost as JS
from megalania_tpu.runtime import pyemit
from megalania_tpu.utils import fixedpoint as jfp
from megalania_tpu_torch.models import packets as TP
from megalania_tpu_torch.ops import scan_cost as TS
from megalania_tpu_torch.utils import fixedpoint as tfp

from util import SAMPLES, random_parse


def _data(data: bytes):
    return np.frombuffer(data, np.uint8).astype(np.int32)


@pytest.mark.parametrize("lc", [0, 3])
@pytest.mark.parametrize("name", ["text", "binary"])
def test_parse_cost_matches_reference(name, lc, rng):
    data = SAMPLES[name]
    slab = random_parse(data, rng)
    hi, lo, probs, live = TS.parse_cost_exact(
        TP.from_u32(slab), torch.as_tensor(_data(data)), lc=lc)
    jhi, jlo, jprobs, jlive = JS.parse_cost_jit(
        jnp.asarray(slab), jnp.asarray(_data(data)), lc=lc)
    assert tfp.to_int(hi, lo) == jfp.to_int(jhi, jlo) \
        == pyemit.parse_cost(data, slab, lc=lc)
    np.testing.assert_array_equal(probs.numpy(), np.asarray(jprobs))
    np.testing.assert_array_equal(live.numpy(), np.asarray(jlive))


@pytest.mark.parametrize("lc", [0, 3])
def test_parse_cost_chain_axis(lc, rng):
    data = SAMPLES["text"]
    slabs = np.stack([random_parse(data, rng) for _ in range(4)])
    hi, lo, probs, live = TS.parse_cost_exact(
        TP.from_u32(slabs), torch.as_tensor(_data(data)), lc=lc)
    assert hi.shape == (4,) and live.shape == slabs.shape
    for c, slab in enumerate(slabs):
        jhi, jlo, jprobs, jlive = JS.parse_cost_jit(
            jnp.asarray(slab), jnp.asarray(_data(data)), lc=lc)
        assert tfp.to_int(hi[c], lo[c]) == jfp.to_int(jhi, jlo)
        np.testing.assert_array_equal(probs[c].numpy(), np.asarray(jprobs))
        np.testing.assert_array_equal(live[c].numpy(), np.asarray(jlive))
