"""The serving step's sync-free pieces on the CPU: what a CUDA graph
captures must compute the same as before and as the JAX package.

- The paged pool update (``attention.paged_write_targets`` and
  ``paged_pool_update``) against JAX ``_paged_pool_update``, bit for bit,
  over idle rows, partial chunks, unmapped columns (page id -1) and
  columns past the table's width.
- ``rope_sincos`` against the formula it replaced (a device tensor as the
  base), bit for bit.
- ``sample_tokens`` with the host's ``any_sampled`` flag against the rule
  it replaced (the flag read from the device), on the same generator
  state; the Gumbel-max draw's distribution against softmax(logits / T)
  in total variation, at a vocabulary of 8; greedy rows stay argmax in a
  mixed batch.
- The engine's packed step inputs: every part 16-byte aligned, and the CPU
  engine runs its step eagerly (no graph).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import attention, layers
from repro_torch.models import transformer as tfm
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.api import Request, make_engine
from repro_torch.serve.sampling import gumbel_like, sample_tokens

torch.set_num_threads(2)

# (chunk_lens, lens, block table) of a batch of 4 rows, T = 6, pages of 4,
# a pool of 10 pages: each case holds at least one valid row
POOL_CASES = {
    # row 0 full, row 1 partial, row 2 idle, row 3 one decode token
    "idle_and_partial": ((6, 3, 0, 1), (0, 5, 0, 9),
                         [[0, 1, -1], [2, 3, -1], [4, -1, -1], [5, 6, 7]]),
    # rows whose chunk runs into unmapped columns (-1 entries)
    "unmapped_columns": ((6, 6, 2, 0), (2, 0, 3, 0),
                         [[1, -1, -1], [3, 2, -1], [-1, 8, -1], [9, -1, -1]]),
    # rows whose chunk runs past the table's width (nb = 2: 8 positions)
    "past_the_table": ((6, 6, 1, 4), (5, 1, 7, 0),
                       [[0, 1], [2, 3], [4, 5], [6, 7]]),
    # a single valid row among idle ones
    "one_valid_row": ((0, 0, 1, 0), (0, 0, 6, 0),
                      [[-1, -1], [-1, -1], [8, 9], [-1, -1]]),
}


def _jax_pool_update(pool, new, positions, bt, clens, page):
    """JAX ``_paged_attend``'s targets, then ``_paged_pool_update``."""
    B, T = positions.shape
    nb = bt.shape[1]
    col = positions // page
    pid = np.take_along_axis(bt, np.clip(col, 0, nb - 1), axis=1)
    ok = (np.arange(T)[None] < clens[:, None]) & (col < nb) & (pid >= 0)
    pid = np.where(ok, pid, pool.shape[0])
    return np.asarray(jattention._paged_pool_update(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(pid),
        jnp.asarray(positions % page)))


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_paged_pool_update_equals_jax_bit_for_bit(case):
    clens, lens, bt = POOL_CASES[case]
    clens, lens = np.asarray(clens, np.int32), np.asarray(lens, np.int32)
    bt = np.asarray(bt, np.int32)
    B, T, P, Hkv, page, D = 4, 6, 10, 2, 4, 8
    rng = np.random.default_rng(len(case))
    pool = rng.standard_normal((P, Hkv, page, D)).astype(np.float32)
    new = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    positions = (lens[:, None] + np.arange(T, dtype=np.int32)[None])
    want = _jax_pool_update(pool, new, positions, bt, clens, page)

    got = torch.from_numpy(pool.copy())
    targets = attention.paged_write_targets(
        torch.from_numpy(positions), torch.from_numpy(bt),
        torch.from_numpy(clens), page)
    attention.paged_pool_update(
        got, torch.from_numpy(new).reshape(B * T, Hkv, D), *targets)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, pool)        # the case writes something


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("head_dim", [16, 64])
def test_rope_sincos_bits_unchanged(theta, head_dim):
    positions = torch.arange(0, 2996, 7, dtype=torch.int32).reshape(2, -1)
    sin, cos = layers.rope_sincos(positions, head_dim, theta)
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    assert torch.equal(sin, torch.sin(ang))
    assert torch.equal(cos, torch.cos(ang))


def _old_sample_tokens(logits, temps, generator):
    """The rule ``sample_tokens`` replaced: the flag read from the temps."""
    greedy = torch.argmax(logits, dim=-1)
    if not bool((temps > 0).any()):
        return greedy
    g = gumbel_like(generator, logits.shape, logits.device)
    sampled = torch.argmax(
        logits / torch.clamp(temps[:, None], min=1e-6) + g, dim=-1)
    return torch.where(temps > 0, sampled, greedy)


@pytest.mark.parametrize("temps", [(0.0, 0.0, 0.0, 0.0), (0.0, 0.7, 0.0, 1.5),
                                   (1.0, 1.0, 1.0, 1.0)])
def test_sample_tokens_with_host_flag_equals_old_rule(temps):
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 50)).astype(np.float32))
    t = torch.tensor(temps)
    g_new = torch.Generator().manual_seed(123)
    g_old = torch.Generator().manual_seed(123)
    for _ in range(3):                   # the generators advance alike
        got = sample_tokens(logits, t, g_new,
                            any_sampled=bool(np.any(np.asarray(temps) > 0)))
        assert torch.equal(got, _old_sample_tokens(logits, t, g_old))
    assert torch.equal(g_new.get_state(), g_old.get_state())


LOGITS = torch.tensor([1.2, -0.3, 0.0, 2.1, -1.0, 0.7, 0.2, -0.6])


@pytest.mark.parametrize("temp", [0.7, 1.0, 2.0])
def test_gumbel_max_draws_follow_softmax(temp):
    """20000 draws in one batch: their empirical distribution is within
    0.02 total variation of softmax(logits / T) (sampling noise at n =
    20000 over 8 tokens is ~0.01)."""
    n = 20000
    logits = LOGITS[None].expand(n, -1).contiguous()
    g = torch.Generator().manual_seed(int(temp * 10))
    toks = sample_tokens(logits, torch.full((n,), temp), g, any_sampled=True)
    hist = np.bincount(toks.numpy(), minlength=8) / n
    target = torch.softmax(LOGITS / temp, dim=-1).numpy()
    assert 0.5 * np.abs(hist - target).sum() < 0.02


def test_greedy_rows_stay_argmax_in_a_mixed_batch():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.0, 2.0, 0.0, 0.5])
    greedy = logits.argmax(-1)
    for seed in range(5):
        toks = sample_tokens(logits, temps, torch.Generator().manual_seed(
            seed), any_sampled=True)
        assert torch.equal(toks[temps == 0], greedy[temps == 0])


@pytest.mark.parametrize("B,C,nb", [(1, 1, 1), (2, 1, 3), (3, 8, 5),
                                    (8, 128, 64)])
def test_packed_step_inputs_are_aligned_and_disjoint(B, C, nb):
    seg, end = engine_mod._segments(B, C, nb)
    spans = sorted(seg.values())
    assert all(o % 4 == 0 for o, _ in spans)      # 16 bytes of int32
    assert all(a[0] + a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] <= end
    assert [seg[k][1] for k in engine_mod._PARTS] == [B * C, B, B, B * nb, B]


def test_cpu_engine_runs_the_step_eagerly():
    """The CPU engine captures no graph; its signatures are still the
    (chunk bucket, table bucket) shapes it ran."""
    cfg = reduce_config(get_config("llama3.2-1b"))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    eng = make_engine(cfg, params, device="cpu", max_slots=2, max_len=32,
                      page_size=4, prefill_chunk=8)
    for i, n in enumerate((3, 11)):
        eng.submit(Request(uid=i, prompt=np.arange(n, dtype=np.int32) + 1,
                           max_new_tokens=3))
    eng.drain()
    st = eng.stats().compile
    assert st.compiled_steps == 0 and st.replays == 0
    assert st.graph_pool_bytes == 0 and st.capture_ms == 0.0
    assert st.step_signatures and all(
        c in eng.chunk_buckets and nb in eng.block_buckets
        for c, nb in st.step_signatures)
