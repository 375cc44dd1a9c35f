"""Port parity of the speculative acceptor and the drafters against the JAX
package, on the CPU: ``runtime/sampling.py::spec_accept_sample`` against
``awq_tpu/runtime/sampling.py:109-178``, ``runtime/speculative.py``'s
``ngram_propose`` and ``_device_draft`` against JAX's.

Greedy rows of the acceptor are a function of the logits alone: emit and
take equal JAX's bit for bit on the same logits. Sampled rows draw from a
``torch.Generator`` where JAX draws from its keys, so they are held to
JAX's guarantee instead, as ``tests/test_spec_sampling.py`` holds JAX's:
the emitted tokens are distributed as ancestral sampling from the
processed logits. Statistic: total variation distance between the
empirical and the analytic distribution over 40000 draws (a batch of
40000 identical rows), within 0.02 for the first token and 0.03 for the
second given an accepted first draft (the standard error of a TV estimate
over 16 tokens at 40000 draws is about 0.005), and the first draft's
acceptance rate within 0.02 of its probability.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.runtime import sampling as tsampling
from awq_tpu_torch.runtime import speculative as tspec

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


def _tv(a, b):
    return float(np.abs(a - b).sum()) / 2


def _contexts(seed, n=40):
    """Random contexts with repeats (some with no earlier match at all)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vocab = int(rng.integers(2, 40))
        length = int(rng.integers(1, 60))
        ctx = rng.integers(0, vocab, length).astype(np.int32)
        if i % 3 == 0:
            ctx = np.tile(ctx[:max(1, length // 4)], 4)[:length]
        out.append(ctx)
    out.append(np.arange(10, dtype=np.int32))
    return out


@pytest.mark.parametrize("k,n", [(3, 3), (7, 3), (5, 2), (4, 1)])
def test_ngram_propose_matches_jax(k, n):
    from awq_tpu.runtime.speculative import ngram_propose as jpropose

    for ctx in _contexts(k * 10 + n):
        got, ref = tspec.ngram_propose(ctx, k, n), jpropose(ctx, k, n)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), (ctx, got, ref)
    # a short max_scan drops the early occurrences, as JAX's does
    ctx = np.tile(np.arange(7, dtype=np.int32), 5)
    assert np.array_equal(tspec.ngram_propose(ctx, k, n, max_scan=9),
                          jpropose(ctx, k, n, max_scan=9))


@pytest.mark.parametrize("k,n", [(3, 3), (7, 3), (4, 2)])
def test_device_draft_matches_jax(k, n):
    """The vectorized drafter over a batch of context buffers (zeros past
    each row's valid length, as the loops keep them) equals JAX's
    ``_device_draft`` row by row: the drafts, junk included, and ``found``."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.runtime.speculative import _device_draft as jdraft

    rng = np.random.default_rng(k + n)
    b, c = 16, 48
    ctx = np.zeros((b, c), np.int64)
    p = rng.integers(1, c - k, b)
    p[:3] = [1, 2, n + 1]
    for i in range(b):
        vocab = int(rng.integers(2, 12))
        ctx[i, :p[i]] = rng.integers(0, vocab, p[i])
    got, found = tspec._device_draft(torch.from_numpy(ctx), torch.from_numpy(p), k, n)
    ref, rfound = jax.vmap(lambda cr, pr: jdraft(cr, pr, k, n))(
        jnp.asarray(ctx, jnp.int32), jnp.asarray(p, jnp.int32))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(found.numpy(), np.asarray(rfound))


def _jax_accept(logits, windows, m_cap, temps, top_ks, top_ps, greedy, seed=0):
    import jax
    import jax.numpy as jnp
    from awq_tpu.runtime.sampling import spec_accept_sample as jaccept

    emit, take = jaccept(jnp.asarray(logits), jnp.asarray(windows, jnp.int32),
                         jnp.asarray(m_cap, jnp.int32), jax.random.PRNGKey(seed),
                         jnp.asarray(temps, jnp.float32), jnp.asarray(top_ks, jnp.int32),
                         jnp.asarray(top_ps, jnp.float32), jnp.asarray(greedy))
    return np.asarray(emit), np.asarray(take)


def _port_accept(logits, windows, m_cap, temps, top_ks, top_ps, greedy, seed=0):
    emit, take = tsampling.spec_accept_sample(
        torch.from_numpy(np.asarray(logits)), torch.from_numpy(np.asarray(windows)),
        torch.from_numpy(np.asarray(m_cap)), torch.tensor(temps, dtype=torch.float32),
        torch.tensor(top_ks), torch.tensor(top_ps, dtype=torch.float32), torch.tensor(greedy),
        generator=torch.Generator().manual_seed(seed))
    return emit.numpy(), take.numpy()


@pytest.mark.parametrize("k", [1, 4, 7])
def test_spec_accept_greedy_rows_bit_equal_to_jax(k):
    """Greedy rows (``greedy`` or a temperature under 1e-5): drafts that
    match the argmax for 0..k positions, ``m_cap`` below the draft length,
    a padded draft, ties in the logits; emit and take equal JAX's."""
    rng = np.random.default_rng(k)
    b, v, w = 12, 32, k + 1
    logits = rng.standard_normal((b, w, v)).astype(np.float32)
    logits[3, :, 5] = logits[3, :, 6] = 9.0            # ties: the first index wins
    argm = logits.argmax(-1)
    windows = rng.integers(0, v, (b, w))
    for i in range(b):
        agree = min(i % (k + 2), k)
        windows[i, 1:agree + 1] = argm[i, :agree]
    m_cap = np.array([k, k, k - 1, k, 0, k, max(k - 2, 0), k, k, 1, k, k])
    temps = np.ones(b, np.float32)
    temps[5:8] = 1e-6                                   # greedy by temperature
    greedy = np.arange(b) < 5
    greedy[8:] = True
    ref = _jax_accept(logits, windows, m_cap, temps, np.zeros(b, np.int64), np.ones(b),
                      greedy)
    got = _port_accept(logits, windows, m_cap, temps, np.zeros(b, np.int64), np.ones(b),
                       greedy)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1]), (got, ref)


def test_spec_accept_mixed_rows_keep_greedy_bits():
    """In a batch that mixes greedy and sampled rows, the greedy rows' emit
    and take equal JAX's bit for bit; the sampled rows' are valid."""
    rng = np.random.default_rng(3)
    b, v, k = 6, 24, 4
    logits = rng.standard_normal((b, k + 1, v)).astype(np.float32) * 2
    argm = logits.argmax(-1)
    windows = np.concatenate([rng.integers(0, v, (b, 1)), argm[:, :k]], axis=1)
    windows[1, 3] = (argm[1, 2] + 1) % v
    m_cap = np.full(b, k)
    greedy = np.array([True, True, False, True, False, False])
    temps = np.full(b, 0.9, np.float32)
    top_ks, top_ps = np.array([0, 0, 5, 0, 0, 3]), np.array([1.0, 1.0, 0.9, 1.0, 0.8, 1.0])
    ref = _jax_accept(logits, windows, m_cap, temps, top_ks, top_ps, greedy)
    got = _port_accept(logits, windows, m_cap, temps, top_ks, top_ps, greedy)
    for i in np.nonzero(greedy)[0]:
        assert np.array_equal(got[0][i], ref[0][i]) and got[1][i] == ref[1][i]
    assert ((got[1] >= 1) & (got[1] <= k + 1)).all()
    for i in np.nonzero(~greedy)[0]:
        t = got[1][i]
        assert np.array_equal(got[0][i, :t - 1], windows[i, 1:t])   # the accepted drafts


def test_spec_accept_sample_distribution():
    """The emitted tokens of a sampled row: the first ~ p_0, the first
    draft accepted at rate p_0(d_1), the second given that ~ p_1 (see the
    module's docstring for the statistic)."""
    rng = np.random.default_rng(0)
    v, k, n = 16, 3, 40000
    logits = rng.standard_normal((1, k + 1, v)).astype(np.float32) * 2.0
    argm = logits[0].argmax(-1)
    window = np.array([5, argm[0], argm[1], argm[2]])
    proc = tsampling.process_logits(torch.from_numpy(logits), torch.tensor([[0.8]]),
                                    torch.tensor([[0]]), torch.tensor([[1.0]]))
    p = torch.softmax(proc, -1)[0].numpy()                     # [W, V]
    emit, take = _port_accept(np.repeat(logits, n, 0), np.repeat(window[None], n, 0),
                              np.full(n, k), np.full(n, 0.8, np.float32), np.zeros(n, np.int64),
                              np.ones(n), np.zeros(n, bool), seed=42)
    hist0 = np.bincount(emit[:, 0], minlength=v) / n
    assert _tv(hist0, p[0]) < 0.02, _tv(hist0, p[0])
    acc = float((take >= 2).mean())
    assert abs(acc - p[0, argm[0]]) < 0.02, (acc, p[0, argm[0]])
    sel = take >= 2
    assert sel.sum() > 5000
    hist1 = np.bincount(emit[sel][:, 1], minlength=v) / sel.sum()
    assert _tv(hist1, p[1]) < 0.03, _tv(hist1, p[1])
    assert (emit[sel][:, 0] == argm[0]).all()


def test_spec_accept_sample_top_k_top_p():
    """top-k and top-p mask both the acceptance probability and the
    residual: no emitted token lies outside the processed support."""
    rng = np.random.default_rng(1)
    v, k, n = 16, 2, 4000
    logits = rng.standard_normal((1, k + 1, v)).astype(np.float32)
    window = np.array([0, 4, 9])
    proc = tsampling.process_logits(torch.from_numpy(logits), torch.tensor([[1.0]]),
                                    torch.tensor([[4]]), torch.tensor([[0.9]]))
    allowed = (proc > -np.inf).numpy()[0]
    emit, take = _port_accept(np.repeat(logits, n, 0), np.repeat(window[None], n, 0),
                              np.full(n, k), np.ones(n, np.float32), np.full(n, 4),
                              np.full(n, 0.9), np.zeros(n, bool), seed=7)
    for j in range(k + 1):
        toks = emit[take >= j + 1][:, j]
        assert allowed[j][toks].all()


def test_spec_accept_empty_residual_takes_the_argmax():
    """A rejected draft that held all the processed mass (``top_k=1`` over a
    logit of +inf: its probability is NaN, so the draft is rejected and the
    residual has nothing left) takes the argmax, as JAX's guard does; both
    sides emit the same bits."""
    v, k = 8, 2
    logits = np.zeros((1, k + 1, v), np.float32)
    logits[0, 0, 3] = np.inf
    windows = np.array([[1, 3, 4]])
    args = (logits, windows, np.array([k]), np.ones(1, np.float32), np.array([1]),
            np.ones(1), np.zeros(1, bool))
    got, ref = _port_accept(*args), _jax_accept(*args)
    assert got[1][0] == 1 and got[0][0, 0] == 3
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
