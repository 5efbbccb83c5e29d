"""Prefix-cache persistence in the port (CPU), mirroring
``tests/test_engine_api.py``'s persistence tests, and the file format
across the two packages:

  * the round trip in the port: an engine saves its index, a new engine
    given ``prefix_cache_path`` loads every page (bit-equal to the file),
    hits on its first pass and gives the same tokens as the first and as a
    cold engine; a page-size mismatch raises (mirrors
    ``test_prefix_cache_persistence_roundtrip``);
  * a file the port saved loads into the JAX package's ``PrefixIndex``
    with the same trie stats and pages, the JAX package saves it again,
    and that file loads into a port engine that serves the same tokens;
  * a missing file is a cold start (mirrors
    ``test_prefix_cache_path_missing_file_is_fine``); a disabled prefix
    cache warns and refuses to save; a pool of another shape raises;
  * ``kvcache.gather_pages``/``scatter_pages`` equal JAX's, and the
    scatter writes into the pool's own tensors;
  * the launcher's ``--prefix-cache-path``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.models import kvcache as jkvcache
from repro.models import transformer as jtfm
from repro.serve.prefix import PrefixIndex as JaxPrefixIndex
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import kvcache
from repro_torch.serve.api import Request, make_engine

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
KW = dict(mode="paged", device="cpu", max_slots=4, max_len=48, page_size=8,
          prefill_chunk=8)
FAM = np.array([4, 2, 4, 2, 4, 2, 4, 2, 9], dtype=np.int32)
REQS = [np.concatenate([FAM, np.array([t], np.int32)]) for t in range(4)]


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce_config(jax_get_config("llama3.2-1b"))
    base = jquant.quantize_params(jtfm.init_params(jcfg, KEY),
                                  JaxQuantConfig(8, 8), min_size=1)
    ad = jlora.init_lora_params(jcfg, jax.random.fold_in(KEY, 1))
    ads = [_to_torch(ad), _to_torch(jax.tree.map(lambda x: x + 0.3, ad))]
    return jcfg, reduce_config(get_config("llama3.2-1b")), _to_torch(base), ads


def _serve(eng, uid0=0):
    for i, p in enumerate(REQS):
        eng.submit(Request(uid=uid0 + i, prompt=p, max_new_tokens=5))
    return {u - uid0: c.tokens for u, c in eng.drain().items()}


def _jax_index_pages(index):
    """Pages the JAX package's index holds, in the order its ``save``
    writes them (the port's ``PrefixIndex.pages``)."""
    nodes, tails = [], []

    def walk(node):
        tails.extend(t.page for t in node.tails)
        for child in node.children.values():
            nodes.append(child.page)
            walk(child)

    for root in index._roots.values():
        walk(root)
    return nodes + tails


def test_prefix_cache_persistence_roundtrip(setup, tmp_path):
    _, cfg, params, ads = setup
    path = str(tmp_path / "prefix.npz")
    eng1 = make_engine(cfg, params, ads, **KW)
    out1 = _serve(eng1)
    saved = eng1.save_prefix_cache(path)
    assert saved > 0 and saved == eng1.stats().prefix_cache.index_pages

    eng2 = make_engine(cfg, params, ads, prefix_cache_path=path, **KW)
    st0 = eng2.stats()
    assert st0.prefix_cache.loaded_pages == saved
    assert (st0.prefix_cache.index_nodes, st0.prefix_cache.index_tails) == (
        eng1.stats().prefix_cache.index_nodes,
        eng1.stats().prefix_cache.index_tails)
    # the restored pages hold the file's arrays, bit for bit
    z = np.load(path)
    got = kvcache.gather_pages(eng2.cache, eng2.prefix.pages())
    for li, entry in enumerate(got):
        for name, arr in entry.items():
            np.testing.assert_array_equal(arr, z[f"pool_{li}_{name}"])
    assert _serve(eng2) == out1
    assert eng2.stats().prefix_cache.hit_tokens > 0

    eng3 = make_engine(cfg, params, ads, **KW)          # cold
    assert _serve(eng3) == out1
    with pytest.raises(ValueError, match="page_size"):
        make_engine(cfg, params, ads, prefix_cache_path=path,
                    **{**KW, "page_size": 4})
    # save_prefix_cache() without a path takes the engine's own
    assert eng2.save_prefix_cache() == eng2.stats().prefix_cache.index_pages
    with pytest.raises(ValueError, match="no path"):
        eng3.save_prefix_cache()


def test_a_file_crosses_between_the_packages_both_ways(setup, tmp_path):
    """The port's file loads into the JAX index over a JAX pool of the same
    layout: the same trie stats and page contents. The JAX package saves
    that index; a port engine loads the JAX file, with the same stats,
    and serves the first engine's tokens with a hit on its first pass."""
    jcfg, cfg, params, ads = setup
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "j.npz")
    eng1 = make_engine(cfg, params, ads, **KW)
    out1 = _serve(eng1)
    n = eng1.save_prefix_cache(port_file)
    layout = jkvcache.PagedLayout(page_size=8, num_pages=eng1.layout.num_pages,
                                  max_slots=4)
    jpool = jkvcache.init_paged_cache(jcfg, layout, 48, kv_dtype=jnp.float32)
    jidx = JaxPrefixIndex(jkvcache.PageAllocator(layout.num_pages), 8)
    jpool, loaded = jidx.load(port_file, jpool)
    assert loaded == n
    want = eng1.prefix.stats()
    assert {k: v for k, v in jidx.stats().items()
            if k != "index_evictions"} == {
        k: v for k, v in want.items() if k != "index_evictions"}
    z = np.load(port_file)
    for li, entry in enumerate(jkvcache.gather_pages(jpool,
                                                     _jax_index_pages(jidx))):
        for name, arr in entry.items():
            np.testing.assert_array_equal(arr, z[f"pool_{li}_{name}"])
    assert jidx.save(jax_file, jpool) == n

    eng2 = make_engine(cfg, params, ads, prefix_cache_path=jax_file, **KW)
    assert eng2.stats().prefix_cache.loaded_pages == n
    assert eng2.prefix.stats()["index_pages"] == want["index_pages"]
    assert _serve(eng2) == out1
    assert eng2.stats().prefix_cache.hit_tokens > 0


def test_missing_file_disabled_cache_and_foreign_pool(setup, tmp_path):
    _, cfg, params, ads = setup
    eng = make_engine(cfg, params, ads, prefix_cache_path=str(
        tmp_path / "nope.npz"), **{**KW, "max_slots": 2, "max_len": 32})
    assert eng.stats().prefix_cache.loaded_pages == 0
    for i in range(2):
        eng.submit(Request(uid=i, prompt=REQS[i], max_new_tokens=2))
    assert len(eng.drain()) == 2
    path = str(tmp_path / "p.npz")
    eng.save_prefix_cache(path)
    with pytest.warns(UserWarning, match="prefix_cache_path ignored"):
        off = make_engine(cfg, params, ads, prefix_cache_path=path,
                          enable_prefix_cache=False, **KW)
    assert off.stats().prefix_cache.loaded_pages == 0
    with pytest.raises(ValueError, match="disabled"):
        off.save_prefix_cache(path)
    # a pool leaf of another head size
    z = dict(np.load(path))
    z["pool_0_kp"] = z["pool_0_kp"][..., :4]
    bad = str(tmp_path / "bad.npz")
    with open(bad, "wb") as f:
        np.savez(f, **z)
    with pytest.raises(ValueError, match="incompatible"):
        make_engine(cfg, params, ads, prefix_cache_path=bad, **KW)


def test_gather_and_scatter_pages_equal_jax_in_place(setup):
    jcfg, cfg, _, _ = setup
    layout = kvcache.PagedLayout(page_size=4, num_pages=6, max_slots=2)
    cache = kvcache.init_paged_cache(cfg, layout, 16, device="cpu")
    rng = np.random.default_rng(0)
    for entry in cache["layers"]:
        for leaf in entry.values():
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(leaf.shape).astype(np.float32)))
    jcache = {"layers": tuple({n: jnp.asarray(v.numpy().copy())
                               for n, v in e.items()}
                              for e in cache["layers"])}
    got, want = (kvcache.gather_pages(cache, [3, 1]),
                 jkvcache.gather_pages(jcache, [3, 1]))
    assert [set(e) for e in got] == [set(e) for e in want]
    for g, w in zip(got, want):
        for name in g:
            np.testing.assert_array_equal(g[name], w[name])
    ptrs = [leaf.data_ptr() for e in cache["layers"] for leaf in e.values()]
    assert kvcache.scatter_pages(cache, [0, 5], got) is cache
    jcache = jkvcache.scatter_pages(jcache, [0, 5], want)
    assert ptrs == [leaf.data_ptr() for e in cache["layers"]
                    for leaf in e.values()]
    for pe, je in zip(cache["layers"], jcache["layers"]):
        for name, leaf in pe.items():
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(je[name]))
    assert kvcache.scatter_pages(cache, [], got) is cache


def test_launch_serve_saves_and_loads_the_prefix_cache(tmp_path, capsys):
    path = str(tmp_path / "launch.npz")
    argv = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "3", "--prompt-families", "1",
            "--prefix-cache-path", path]
    first = launch_serve.main(argv)
    out = capsys.readouterr().out
    assert "pages saved to" in out and "pages loaded" not in out
    second = launch_serve.main(argv)
    assert {u: c.tokens for u, c in second.items()} == {
        u: c.tokens for u, c in first.items()}
    assert "pages loaded from" in capsys.readouterr().out
