"""MoE LoRA fine-tuning in the port against the JAX package, on the CPU.

  * ``grouped_crossbar_matmul_t_plain`` (the grouped product's dx) and the
    backward of ``GroupedCrossbarMatmulFn`` on CPU tensors, against
    ``jax.vjp`` of the JAX package's dequantize-then-``"sbcd,sdf->sbcf"``
    (``static_einsum``) on the same codes: int8 and int4, an empty slot, a
    slot over two row tiles, ragged K and N; every row past a slot's count
    exactly 0 in dx. Tolerance 1e-4 of max |dx|, as for the crossbar dx
    (f32 sums in another order);
  * capacity dispatch at a capacity factor of 0.5, which drops tokens: the
    dropped count equal to JAX's, the loss within 1e-5 (relative) and every
    LoRA gradient within 1e-4 (relative L2) of ``jax.value_and_grad``, on
    an M8F8 base whose expert products' dx runs through the Function.

The loss and LoRA gradients of llama4-scout and mixtral at the config's
capacity are ``tests/test_torch_train.py``'s (dense and M8F8). Reduced
configs (2 layers, d 64, 4 experts).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import hetero as jhetero
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.data import pipeline as jpipeline
from repro.models import transformer as jtfm
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.train import steps

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# (label, K, N, rows per slot): ragged K and N with an empty slot and a
# slot over two 64-row tiles; whole crossbars with a full tile, one row
# and an empty last slot
DX_CASES = [("ragged", 200, 130, [5, 0, 70, 3]),
            ("tiles", 256, 384, [64, 1, 0])]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", DX_CASES, ids=[c[0] for c in DX_CASES])
def test_grouped_dx_plain_matches_jax_vjp(case, bits):
    _, K, N, counts = case
    slots = len(counts)
    tile = cb_ops.GROUPED_TILE["prefill"]
    rng = np.random.default_rng(K + N + bits)
    w = (rng.standard_normal((slots, K, N)) / 16).astype(np.float32)
    jq = jquant.quantize(jnp.asarray(w), bits)
    tq = bridge.to_torch(_np(jq), "cpu")
    c = torch.tensor(counts, dtype=torch.int32)
    bases = torch.cat([torch.zeros(1, dtype=torch.int32),
                       torch.cumsum((c + tile - 1) // tile * tile, 0)
                       .to(torch.int32)])
    R = cb_ops.grouped_rows(sum(counts), slots, tile)
    # padding rows hold data too: none of it may reach dx
    x = rng.standard_normal((R, K)).astype(np.float32)
    gy = rng.standard_normal((R, N)).astype(np.float32)

    # JAX: each slot's live rows in its (1, C) buffer, the cotangent 0
    # past them
    C = max(max(counts), 1)
    xin = np.zeros((slots, 1, C, K), np.float32)
    gin = np.zeros((slots, 1, C, N), np.float32)
    for s, (b, n) in enumerate(zip(bases.tolist(), counts)):
        xin[s, 0, :n], gin[s, 0, :n] = x[b:b + n], gy[b:b + n]
    _, vjp = jax.vjp(
        lambda a: jhetero.static_einsum("sbcd,sdf->sbcf", a, jq),
        jnp.asarray(xin))
    dx_j = np.asarray(vjp(jnp.asarray(gin))[0])
    want = np.zeros((R, K), np.float32)
    live = np.zeros(R, bool)
    for s, (b, n) in enumerate(zip(bases.tolist(), counts)):
        want[b:b + n] = dx_j[s, 0, :n]
        live[b:b + n] = True

    g = torch.from_numpy(gy)
    got = [cb_ops.grouped_crossbar_matmul_t_plain(g, tq, bases, c),
           cb_ops.grouped_crossbar_matmul_t(g, tq, bases, c)]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = cb_ops.grouped_crossbar_matmul(xt, tq, bases, c, "prefill")
    assert type(y.grad_fn).__name__ == "GroupedCrossbarMatmulFnBackward"
    (y * g).sum().backward()
    got.append(xt.grad)
    atol = 1e-4 * float(np.abs(want).max())
    for dx in got:
        assert bool((dx[torch.from_numpy(~live)] == 0).all())
        np.testing.assert_allclose(dx.numpy(), want, rtol=1e-4, atol=atol)
    # the decode kernel's 8-row layout has no dx: refused under grad
    with pytest.raises(ValueError, match="prefill"):
        cb_ops.grouped_crossbar_matmul(xt, tq, bases, c, "decode")


def test_capacity_drops_match_jax_with_gradients(monkeypatch):
    """llama4-scout (reduced: 4 experts, top-1, a shared expert) on an M8F8
    base at capacity factor 0.5: 16-token sequences put 2 rows a slot, so
    tokens drop. The dropped count of the forward equals JAX's; the loss
    and every LoRA gradient match JAX's ``value_and_grad``; each expert
    product's dx ran through the grouped Function."""
    arch = "llama4-scout-17b-a16e"
    jcfg = jreduce_config(jget_config(arch))
    cfg = reduce_config(get_config(arch))
    key = jax.random.PRNGKey(0)
    jparams = jquant.quantize_params(jtfm.init_params(jcfg, key),
                                     JQuantConfig(8, 8), min_size=1)
    jl = _np(jlora.init_lora_params(jcfg, jax.random.fold_in(key, 1)))
    rng = np.random.default_rng(5)
    for entry in jl["layers"]:
        for ab in entry.values():    # B != 0: A's gradient is not 0
            ab["b"] = (0.02 * rng.standard_normal(ab["b"].shape)).astype(
                np.float32)
    params = bridge.to_torch(_np(jparams), "cpu")
    lora = bridge.to_torch(jl, "cpu")
    jb = jpipeline.SyntheticLM(cfg.vocab_size, seed=3).batch(0, 4, 16)
    tb = {k: torch.from_numpy(v) for k, v in jb.items()}
    jec, ec = (jtfm.ExecConfig(capacity_factor=0.5),
               tfm.ExecConfig(capacity_factor=0.5))

    def jax_side(lo, p, b):
        # one program: the step's value_and_grad and the forward's drops
        vg = jax.value_and_grad(jsteps.make_loss_fn(jcfg, jec),
                                has_aux=True)(lo, p, b, None)
        aux = jtfm.forward(jcfg, p, {"tokens": b["tokens"]}, lora=lo,
                           mode="train", exec_cfg=jec)[2]
        return vg, aux["moe_dropped_tokens"]

    ((jloss, _), jg), jdrop = jax.jit(jax_side)(
        jax.tree.map(jnp.asarray, jl), jparams, jax.tree.map(jnp.asarray, jb))
    with torch.no_grad():
        _, _, aux = tfm.forward(cfg, params, {"tokens": tb["tokens"]},
                                lora=lora, mode="train", exec_cfg=ec)
    assert float(aux["moe_dropped_tokens"]) > 0
    assert float(aux["moe_dropped_tokens"]) == float(jdrop)

    dx_calls = []
    plain_t = cb_ops.grouped_crossbar_matmul_t

    def counted(*a, **kw):
        dx_calls.append(a[1].orig_shape)
        return plain_t(*a, **kw)

    monkeypatch.setattr(cb_ops, "grouped_crossbar_matmul_t", counted)
    (loss, _), tg = steps.value_and_grad(steps.make_loss_fn(cfg, ec), lora,
                                         params, tb, None)
    # w1, w3 and w2 of each MoE layer
    assert len(dx_calls) == 3 * cfg.n_layers
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jleaves, tleaves = jax.tree.leaves(jg), list(adamw.leaves(tg))
    assert len(jleaves) == len(tleaves) > 0
    for a, b in zip(tleaves, jleaves):
        assert np.linalg.norm(np.asarray(b)) > 0
        assert _rel(a.numpy(), b) <= 1e-4
