"""Port parity for the kernels' plain versions against the JAX package's
Pallas kernels (interpret mode) and oracles. The kernels themselves are
held against these plain versions on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.

Tolerances: crossbar 1e-4 relative (f32), as ``tests/test_kernels.py``
sets for the Pallas kernel — the plain version dequantizes before the
product, the kernel scales each 128-deep partial sum, and the two sum in
different orders. Flash 2e-5, as for the Pallas
kernel: both are f32 softmax attention summed in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.core.quant import quantize as jax_quantize
from repro.kernels.crossbar_matmul import ops as jcb_ops
from repro.kernels.crossbar_matmul import ref as jcb_ref
from repro.kernels.flash_attention import ops as jfa_ops
from repro.models import attention as jattn
from repro_torch import kernels
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import quant
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# crossbar_matmul
# ---------------------------------------------------------------------------

CB_SWEEP = [(32, 128, 128), (64, 256, 384), (100, 300, 130), (8, 520, 250)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mkn", CB_SWEEP)
def test_crossbar_plain_matches_pallas_and_ref(bits, mkn):
    """f32 activations: the port's kernel takes f32 only."""
    M, K, N = mkn
    rng = np.random.default_rng(M * K * N + bits)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qj = jax_quantize(jnp.asarray(w), bits)
    y_pallas = np.asarray(jcb_ops.crossbar_matmul(jnp.asarray(x), qj,
                                                  block_m=128))
    y_ref = np.asarray(jcb_ref.crossbar_matmul_ref(jnp.asarray(x), qj))
    y = cb_ops.crossbar_matmul(torch.from_numpy(x),
                               quant.quantize(torch.from_numpy(w), bits))
    for other in (y_pallas, y_ref):
        np.testing.assert_allclose(y.numpy(), other, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(y_ref).max()))


def test_crossbar_lead_dims_and_refusals():
    rng = np.random.default_rng(1)
    qt = quant.quantize(torch.from_numpy(
        (rng.standard_normal((256, 128)) * 0.1).astype(np.float32)), 8)
    x = torch.from_numpy(rng.standard_normal((2, 5, 256)).astype(np.float32))
    y = cb_ops.crossbar_matmul(x, qt)
    assert y.shape == (2, 5, 128)
    np.testing.assert_allclose(
        y.numpy(), (x @ quant.dequantize(qt)).numpy(), rtol=1e-5, atol=1e-5)
    # no silent fallback: a tensor that is not on the CPU and not on CUDA
    # has no kernel, and the plain version is never taken for it
    with pytest.raises(ValueError):
        cb_ops.crossbar_matmul(x.to("meta"), qt)
    with pytest.raises(ValueError, match="2-D"):
        cb_ops.crossbar_matmul(x, quant.quantize(torch.zeros(2, 256, 128), 8))


# ---------------------------------------------------------------------------
# flash attention (contiguous)
# ---------------------------------------------------------------------------

FA_SWEEP = [(2, 64, 64, 4, 2, 16), (1, 32, 96, 4, 4, 8), (2, 64, 64, 8, 2, 32),
            (1, 1, 64, 4, 2, 16), (1, 48, 48, 6, 3, 64)]
FA_FLAGS = [(None, None), (16, None), (None, 20.0)]


def _qkv(B, T, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D", FA_SWEEP)
@pytest.mark.parametrize("window,softcap", FA_FLAGS)
def test_flash_plain_matches_pallas_and_ref(B, T, S, Hq, Hkv, D, window,
                                            softcap):
    q, k, v = _qkv(B, T, S, Hq, Hkv, D, T * S * Hq + D)
    qpos = np.broadcast_to(np.arange(S - T, S)[None], (B, T)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    o_pallas = np.asarray(jfa_ops.flash_attention(
        *map(jnp.asarray, (q, k, v, qpos, kpos)), window=window,
        softcap=softcap))
    o_ref = np.asarray(jattn.ref_attention(
        *map(jnp.asarray, (q, k, v, qpos, kpos)), window=window,
        softcap=softcap))
    o = fa_ops.flash_attention(*_t(q, k, v, qpos, kpos), window=window,
                               softcap=softcap).numpy()
    np.testing.assert_allclose(o, o_pallas, rtol=2e-5, atol=2e-5)
    # every row here sees at least one key, so ref_attention agrees too
    np.testing.assert_allclose(o, o_ref, rtol=2e-5, atol=2e-5)
    o_port_ref = attention.ref_attention(*_t(q, k, v, qpos, kpos),
                                         window=window, softcap=softcap)
    np.testing.assert_allclose(o_port_ref.numpy(), o_ref, rtol=2e-5,
                               atol=2e-5)


def test_flash_plain_rows_without_keys_and_invalid_slots():
    """kv_pos == -1 contributes nothing; a row that sees no key gives 0 (as
    the Pallas kernel), where ref_attention gives the mean of V."""
    B, T, S, H, D = 1, 8, 32, 2, 16
    q, k, v = _qkv(B, T, S, H, H, D, 11)
    qpos = (np.arange(T)[None] + 100).astype(np.int32)
    qpos[0, 0] = 50                                  # sees no key
    kpos = np.where(np.arange(S) < 20, np.arange(S) + 90, -1)[None]
    kpos = kpos.astype(np.int32)
    o1 = fa_ops.flash_attention(*_t(q, k, v, qpos, kpos)).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[:, 20:], v2[:, 20:] = 999.0, -999.0
    o2 = fa_ops.flash_attention(*_t(q, k2, v2, qpos, kpos)).numpy()
    np.testing.assert_allclose(o1, o2, atol=1e-6)
    assert np.all(o1[0, 0] == 0.0)
    o_pallas = np.asarray(jfa_ops.flash_attention(
        *map(jnp.asarray, (q, k, v, qpos, kpos)), block_q=8, block_kv=8))
    np.testing.assert_allclose(o1, o_pallas, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# paged flash attention vs the JAX page-pool branch of _paged_attend
# ---------------------------------------------------------------------------


def _paged_case(seed, B=4, T=8, page=4, nb=5, n_pages=24):
    """Random pool, block tables with -1 holes, ragged chunk_lens (one idle
    row), positions lens + arange(T)."""
    jcfg = jax_reduce_config(jax_get_config("llama3.2-1b"))
    rng = np.random.default_rng(seed)
    Hq, Hkv, D = jcfg.n_heads, jcfg.n_kv_heads, jcfg.hd
    kp = rng.standard_normal((n_pages, Hkv, page, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, Hkv, page, D)).astype(np.float32)
    perm = rng.permutation(n_pages)[:B * nb].reshape(B, nb).astype(np.int32)
    lens = np.array([0, 5, 9, 0], np.int32)[:B]     # row 3 is an idle slot
    clens = np.array([8, 1, 6, 0], np.int32)[:B]
    need = -(-(lens + clens) // page)
    bt = np.where(np.arange(nb)[None] < need[:, None], perm, -1)
    bt[2, 0] = -1                                  # a hole inside the range
    positions = (lens[:, None] + np.arange(T)[None]).astype(np.int32)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return jcfg, dict(q=q, k=k, v=v, kp=kp, vp=vp, bt=bt, lens=lens,
                      clens=clens, positions=positions, page=page)


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_plain_matches_jax_paged_attend(seed):
    jcfg, c = _paged_case(seed)
    paged = {"block_table": jnp.asarray(c["bt"]), "lens": jnp.asarray(c["lens"]),
             "chunk_lens": jnp.asarray(c["clens"]), "page_size": c["page"]}
    o_jax, new = jattn._paged_attend(
        jcfg, *map(jnp.asarray, (c["q"], c["k"], c["v"], c["positions"])),
        {"kp": jnp.asarray(c["kp"]), "vp": jnp.asarray(c["vp"])}, paged,
        kind="full", softcap=None, impl="ref", block_q=2048, block_kv=512,
        sharder=None)
    o_jax = np.asarray(o_jax)

    cfg = reduce_config(get_config("llama3.2-1b"))
    pool = {"kp": torch.from_numpy(c["kp"].copy()),
            "vp": torch.from_numpy(c["vp"].copy())}
    tpaged = {"block_table": torch.from_numpy(c["bt"]),
              "lens": torch.from_numpy(c["lens"]),
              "chunk_lens": torch.from_numpy(c["clens"]),
              "page_size": c["page"]}
    q, k, v, pos = _t(c["q"], c["k"], c["v"], c["positions"])
    o = attention.paged_attend(cfg, q, k, v, pos, pool, tpaged, kind="full",
                               softcap=None, impl="auto").numpy()
    # the chunk's K/V land in the pool exactly where JAX scatters them
    np.testing.assert_array_equal(pool["kp"].numpy(), np.asarray(new["kp"]))
    np.testing.assert_array_equal(pool["vp"].numpy(), np.asarray(new["vp"]))
    kv_pos = fa_ops.paged_kv_pos(*_t(c["bt"], c["lens"], c["clens"]),
                                 c["page"]).numpy()
    sees = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :]
                                        <= c["positions"][:, :, None])
    rows = sees.any(-1)                             # (B, T)
    assert rows.sum() > 0 and (~rows).sum() > 0
    np.testing.assert_allclose(o[rows], o_jax[rows], rtol=2e-5, atol=2e-5)
    assert np.all(o[~rows] == 0.0)
    # the "ref" implementation reproduces JAX on every row
    pool2 = {"kp": torch.from_numpy(c["kp"].copy()),
             "vp": torch.from_numpy(c["vp"].copy())}
    o_ref = attention.paged_attend(cfg, q, k, v, pos, pool2, tpaged,
                                   kind="full", softcap=None, impl="ref")
    np.testing.assert_allclose(o_ref.numpy(), o_jax, rtol=2e-5, atol=2e-5)


def test_launch_counters_move_only_on_kernel_launches():
    kernels.reset_launches()
    q, k, v = _qkv(1, 4, 8, 2, 2, 16, 0)
    pos = np.arange(4, dtype=np.int32)[None] + 4
    kpos = np.arange(8, dtype=np.int32)[None]
    fa_ops.flash_attention(*_t(q, k, v, pos, kpos))
    cb_ops.crossbar_matmul(torch.zeros(2, 128),
                           quant.quantize(torch.ones(128, 128), 8))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
