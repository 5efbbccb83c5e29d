"""Port parity for the model: smoke llama3.2-1b ``forward`` in the port
(plain kernel versions on the CPU) against the JAX package's ``forward`` on
the same weights, carried across by ``repro_torch.bridge``.

Tolerance 1e-4 absolute on logits of magnitude ~0.5: both sides run in
f32 (TF32 off), and only the order of the sums differs (observed ~1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import replay_greedy

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.core import hetero as jhetero
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.models import transformer as jtfm
from repro_torch import bridge, resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import hetero, lora
from repro_torch.models import transformer as tfm
from repro_torch.serve.api import make_engine

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False   # f32 reference products
KEY = jax.random.PRNGKey(0)
TOL = 1e-4


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce_config(jax_get_config("llama3.2-1b"))
    cfg = reduce_config(get_config("llama3.2-1b"))
    base = jtfm.init_params(jcfg, KEY)
    # smoke weights fall under quantize_params' default min_size
    m8f8 = jquant.quantize_params(base, JaxQuantConfig(8, 8), min_size=1)
    ads = [jlora.init_lora_params(jcfg, jax.random.fold_in(KEY, i + 1))
           for i in range(3)]
    # B starts at zero: shift every leaf so each adapter changes the output
    ads = [jax.tree.map(lambda x, s=0.05 * (i + 1): x + s, a)
           for i, a in enumerate(ads)]
    return {"jcfg": jcfg, "cfg": cfg,
            "jax": {"plain": base, "m8f8": m8f8},
            "torch": {"plain": _to_torch(base), "m8f8": _to_torch(m8f8)},
            "jads": ads, "tads": [_to_torch(a) for a in ads]}


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("base", ["plain", "m8f8"])
def test_prefill_then_decode_logits_match_jax(setup, base):
    """Three rows, each on its own adapter, without and with the M8F8 base."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp, tp = setup["jax"][base], setup["torch"][base]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    idx = np.array([2, 0, 1])
    jkw = dict(lora=jlora.stack_adapters(setup["jads"]),
               adapter_idx=jnp.asarray(idx))
    tkw = dict(lora=lora.stack_adapters(setup["tads"]),
               adapter_idx=torch.as_tensor(idx))
    lj, cj, _ = jtfm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                             mode="prefill", prefill_cache_len=16, **jkw)
    lt, ct, _ = tfm.forward(cfg, tp, {"tokens": torch.as_tensor(toks)},
                            mode="prefill", prefill_cache_len=16, **tkw)
    _close(lt, lj)
    _close(ct["layers"][0]["k"], cj["layers"][0]["k"])
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
        lj, cj, _ = jtfm.forward(jcfg, jp, {"tokens": jnp.asarray(nxt)},
                                 mode="decode", cache=cj, **jkw)
        lt, ct, _ = tfm.forward(cfg, tp, {"tokens": torch.as_tensor(nxt)},
                                mode="decode", cache=ct, **tkw)
        _close(lt, lj)
    np.testing.assert_array_equal(ct["layers"][0]["len"].numpy(),
                                  np.asarray(cj["layers"][0]["len"]))


def _port_greedy(cfg, params, adapters, prompt, n, adapter_id, max_len):
    """The port's own token-at-a-time replay (mirrors tests/oracle.py)."""
    ads = lora.stack_adapters(adapters)
    idx = torch.tensor([adapter_id])
    lg, cache, _ = tfm.forward(cfg, params, {"tokens": torch.as_tensor(
        prompt)[None]}, lora=ads, adapter_idx=idx, mode="prefill",
        prefill_cache_len=max_len)
    toks = [int(lg[0, -1].argmax())]
    while len(toks) < n:
        lg, cache, _ = tfm.forward(cfg, params, {"tokens": torch.tensor(
            [[toks[-1]]])}, lora=ads, adapter_idx=idx, mode="decode",
            cache=cache)
        toks.append(int(lg[0, -1].argmax()))
    return toks


@pytest.mark.parametrize("plen,adapter_id", [(9, 0), (14, 2)])
def test_greedy_tokens_equal_replay_oracle_m8f8(setup, plen, adapter_id):
    rng = np.random.default_rng(plen)
    prompt = rng.integers(0, setup["cfg"].vocab_size, plen).astype(np.int32)
    ref = replay_greedy(setup["jcfg"], setup["jax"]["m8f8"], setup["jads"],
                        prompt, 4, adapter_id=adapter_id, max_len=32)
    got = _port_greedy(setup["cfg"], setup["torch"]["m8f8"], setup["tads"],
                       prompt, 4, adapter_id, 32)
    assert got == ref


def test_train_mode_loss_and_flop_tally_match_jax(setup):
    """mode="train" logits, lm_loss, and the Eq. 5 FLOP tally (static vs
    dynamic engine) agree with the JAX package."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) > 0.2).astype(np.float32)
    idx = np.array([1, 2])
    jkw = dict(lora=jlora.stack_adapters(setup["jads"]),
               adapter_idx=jnp.asarray(idx))
    tkw = dict(lora=lora.stack_adapters(setup["tads"]),
               adapter_idx=torch.as_tensor(idx))

    def jfwd(p):
        # unrolled: the JAX tally counts at trace time, and lax.scan traces
        # its body once for all n_sp periods
        return jtfm.forward(jcfg, p, {"tokens": jnp.asarray(toks)},
                            exec_cfg=jtfm.ExecConfig(scan_layers=False),
                            **jkw)[0]

    lj = jfwd(setup["jax"]["m8f8"])
    with hetero.tally() as t:
        lt, _, _ = tfm.forward(cfg, setup["torch"]["m8f8"],
                               {"tokens": torch.as_tensor(toks)}, **tkw)
    _close(lt, lj)
    loss_j, aux_j = jtfm.lm_loss(jcfg, lj, jnp.asarray(labels),
                                 jnp.asarray(mask))
    loss_t, aux_t = tfm.lm_loss(cfg, lt, torch.as_tensor(labels),
                                torch.as_tensor(mask))
    assert abs(float(loss_t) - float(loss_j)) < TOL
    assert float(aux_t["tokens"]) == float(aux_j["tokens"])
    report = jhetero.breakdown_of(jfwd, setup["jax"]["m8f8"])
    assert t[hetero.STATIC] == report.static_flops
    assert t[hetero.DYNAMIC] == report.dynamic_flops
    assert t["nonlinear"] == report.nonlinear_elems


def test_init_params_layout_matches_jax_and_is_seeded(setup):
    cfg = setup["cfg"]
    a = tfm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = tfm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    ref = setup["torch"]["plain"]

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree

    la, lb, lr = list(leaves(a)), list(leaves(b)), list(leaves(ref))
    assert [p for p, _ in la] == [p for p, _ in lr]
    for (p, x), (_, y), (_, r) in zip(la, lb, lr):
        assert x.shape == r.shape and x.dtype == r.dtype, p
        assert torch.equal(x, y), p
    wq = a["layers"][0]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6


def test_entry_points_refuse_cpu_unless_asked(setup, monkeypatch):
    """Without a card and without device="cpu" the port raises instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = setup["cfg"]
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(cfg, setup["torch"]["plain"], setup["tads"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.to_torch({"w": np.zeros(2)})
    assert resolve_device("cpu").type == "cpu"


def test_config_copy_matches_jax_field_for_field(setup):
    """The port's configs are a copy: same fields, same values."""
    import dataclasses
    pairs = [(jax_get_config("llama3.2-1b"), get_config("llama3.2-1b")),
             (setup["jcfg"], setup["cfg"])]
    for arch in ("gemma2-9b",):
        jc, tc = jax_get_config(arch), get_config(arch)
        pairs += [(jc, tc), (jax_reduce_config(jc), reduce_config(tc))]
    for jc, tc in pairs:
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


def test_unported_architectures_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("jamba-1.5-large-398b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
