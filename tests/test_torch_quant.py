"""Port parity: crossbar-wise quantization codes equal the JAX package's bit
for bit (8- and 4-bit, ragged K/N, stacked layers) and dequantize agrees."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.core import quant as jquant
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.core import quant

torch.set_num_threads(2)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(128, 128), (256, 384), (300, 130),
                                   (520, 250), (3, 200, 130)])
def test_codes_bit_exact_and_dequantize(bits, shape):
    rng = np.random.default_rng(sum(shape) + bits)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[..., 0, 0] = 0.35                         # a block with a clear absmax
    qj = jquant.quantize(jnp.asarray(w), bits)
    qt = quant.quantize(torch.from_numpy(w), bits)
    assert qt.codes.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(qj.codes))
    np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(qj.scales))
    assert qt.orig_shape == tuple(qj.orig_shape)
    # dequantize is code * scale in f32 on both sides: exact
    np.testing.assert_array_equal(
        quant.dequantize(qt).numpy(),
        np.asarray(jquant.dequantize(qj, jnp.float32)))
    if bits == 4:
        np.testing.assert_array_equal(quant._unpack4(qt.codes).numpy(),
                                      np.asarray(jquant._unpack4(qj.codes)))


def test_rounding_ties_to_even_like_jax():
    """Values that land exactly on .5 code steps round half to even."""
    w = np.zeros((128, 128), np.float32)
    w[0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, 64.5]
    qj = jquant.quantize(jnp.asarray(w), 8)
    qt = quant.quantize(torch.from_numpy(w), 8)
    np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(qj.codes))
    assert qt.codes[0, :8].tolist() == [127, 0, 2, 2, 0, -2, 64, 64]


def test_quantize_params_matches_jax_tree():
    """M8F8 over a smoke llama tree: the same leaves are quantized, to the
    same codes, and the bridge carries JAX's QuantizedTensor across."""
    cfg = jax_reduce_config(jax_get_config("llama3.2-1b"))
    pj = jtfm.init_params(cfg, jax.random.PRNGKey(3))
    qj = jquant.quantize_params(pj, JaxQuantConfig(8, 8), min_size=1)
    pt = bridge.to_torch(jax.tree.map(np.asarray, pj), "cpu")
    qt = quant.quantize_params(pt, quant_cfg=JaxQuantConfig(8, 8), min_size=1)
    via_bridge = bridge.to_torch(jax.tree.map(np.asarray, qj), "cpu")
    for name in ("wq", "wk", "wv", "wo"):
        mine = qt["layers"][0]["attn"][name]
        theirs = via_bridge["layers"][0]["attn"][name]
        assert quant.is_quantized(mine) and quant.is_quantized(theirs)
        np.testing.assert_array_equal(mine.codes.numpy(),
                                      theirs.codes.numpy())
        np.testing.assert_array_equal(mine.scales.numpy(),
                                      theirs.scales.numpy())
        assert mine.orig_shape == theirs.orig_shape
    for name in ("w1", "w2", "w3"):
        np.testing.assert_array_equal(
            qt["layers"][0]["ff"][name].codes.numpy(),
            via_bridge["layers"][0]["ff"][name].codes.numpy())
    # norms and the embedding are never quantized
    assert not quant.is_quantized(qt["embed"]["table"])
    assert not quant.is_quantized(qt["layers"][0]["norm"]["scale"])
    # default min_size leaves smoke-size weights alone, as in JAX
    untouched = quant.quantize_params(pt, quant_cfg=JaxQuantConfig(8, 8))
    assert not quant.is_quantized(untouched["layers"][0]["attn"]["wq"])


def test_layer_slice_of_stacked_weight():
    w = torch.randn(3, 200, 130, generator=torch.Generator().manual_seed(0))
    qt = quant.quantize(w, 8)
    one = qt.layer(1)
    assert one.orig_shape == (200, 130)
    np.testing.assert_array_equal(quant.dequantize(one).numpy(),
                                  quant.dequantize(qt)[1].numpy())
