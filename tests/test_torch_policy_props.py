"""Property tests of the policy layer against the JAX reference: twins of
the hypothesis tests of tests/test_policy.py (exact inside top-k, k̂
monotone in min_block and clamped) and tests/test_verify.py (the accepted
block is a prefix of the draft, exact acceptance is token equality, k̂
monotone under a tightened top-k or distance).  Each example draws
proposals and p_1 logits from a seed with numpy, runs the port's acceptor
and block schedule beside the reference's on the same arrays, and
requires equal accepts and k̂ on top of the property."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _hyp import given, settings, st  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro_torch.config import DecodeConfig  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402

CRITERIA = ("exact", "topk", "distance")


def _random_case(seed, b=4, k=5, vocab=13):
    """tests/test_policy.py's and tests/test_verify.py's draw (vocab 13
    and 17): proposals (b, k) int32 and p_1 logits (b, k, vocab) fp32."""
    rng = np.random.default_rng(seed)
    props = rng.integers(0, vocab, (b, k)).astype(np.int32)
    logits = rng.normal(size=(b, k, vocab)).astype(np.float32)
    return props, logits


def _accepts(props, logits, dec_kw):
    """(port accepts, reference accepts) as numpy bool arrays, required
    equal, through each side's registered policy for ``dec_kw``."""
    tacc = tpolicy.resolve_policy(DecodeConfig(**dec_kw)).acceptor.accepts(
        torch.tensor(props), torch.tensor(logits))
    jacc = jpolicy.resolve_policy(JDecodeConfig(**dec_kw)).acceptor.accepts(
        jnp.asarray(props), jnp.asarray(logits))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    return tacc.numpy()


def _khat(accepts, remaining, **schedule_kw):
    """k̂ of the port's StaticSchedule, required equal to the reference's."""
    t, _ = tpolicy.StaticSchedule(**schedule_kw).block_size(
        torch.tensor(accepts), torch.tensor(remaining, dtype=torch.int32), ())
    j, _ = jpolicy.StaticSchedule(**schedule_kw).block_size(
        jnp.asarray(accepts), jnp.asarray(remaining, jnp.int32), ())
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return t.numpy()


# ---------------------------------------------------------------------------
# tests/test_policy.py:34-66
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), top_k=st.integers(1, 5))
def test_exact_accepts_subset_of_topk(seed, top_k):
    """Every exact-accepted position is top-k-accepted, so exact-accepted
    prefixes are no longer than top-k-accepted ones."""
    props, logits = _random_case(seed)
    exact = _accepts(props, logits, dict(policy="exact"))
    topk = _accepts(props, logits, dict(policy="topk", top_k=top_k))
    assert np.all(~exact | topk)
    rem = np.full((4,), 99, np.int32)
    assert np.all(_khat(exact, rem) <= _khat(topk, rem))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), m1=st.integers(1, 6), m2=st.integers(1, 6),
       remaining=st.integers(1, 8))
def test_khat_monotone_in_min_block_and_clamped(seed, m1, m2, remaining):
    """k̂ is monotone in min_block, in [1, k], and clamped by the
    remaining budget."""
    rng = np.random.default_rng(seed)
    k = 5
    accepts = rng.random((3, k)) < 0.5
    accepts[:, 0] = True
    rem = np.full((3,), remaining, np.int32)
    lo, hi = min(m1, m2), max(m1, m2)
    khat_lo = _khat(accepts, rem, min_block=lo)
    khat_hi = _khat(accepts, rem, min_block=hi)
    assert np.all(khat_lo <= khat_hi)
    for khat in (khat_lo, khat_hi):
        assert np.all(khat >= 1)
        assert np.all(khat <= max(remaining, 1))
        assert np.all(khat <= k)


# ---------------------------------------------------------------------------
# tests/test_verify.py:122-195
# ---------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), crit=st.sampled_from(CRITERIA))
def test_accepted_prefix_is_prefix_of_draft(seed, crit):
    """For every acceptor the committed block is a prefix of the draft:
    every position below k̂ was accepted, the next one (if any) was not,
    and 1 <= k̂ <= k."""
    props, logits = _random_case(seed, vocab=17)
    acc = _accepts(props, logits, dict(criterion=crit, top_k=2, epsilon=2.0))
    khat = _khat(acc, np.full((4,), 100, np.int32))
    k = props.shape[1]
    assert np.all(khat >= 1) and np.all(khat <= k)
    for i in range(acc.shape[0]):
        assert acc[i, :khat[i]].all(), (i, acc[i], khat[i])
        if khat[i] < k:
            assert not acc[i, khat[i]], (i, acc[i], khat[i])


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_exact_acceptance_implies_token_equality(seed):
    """§3: an accepted candidate at position j >= 1 is the verifier's
    greedy token at slot j - 1, which checks it."""
    props, logits = _random_case(seed, vocab=17)
    acc = _accepts(props, logits, dict(criterion="exact"))
    greedy = np.argmax(logits, axis=-1)
    b, k = props.shape
    assert acc[:, 0].all()
    for i in range(b):
        for j in range(1, k):
            assert acc[i, j] == (props[i, j] == greedy[i, j - 1])


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), k_lo=st.integers(1, 6),
       k_hi=st.integers(1, 6))
def test_khat_monotone_under_tightened_topk(seed, k_lo, k_hi):
    """Tightening §5.1's top-k never grows k̂, and the accepts shrink as a
    set."""
    props, logits = _random_case(seed, vocab=17)
    lo, hi = min(k_lo, k_hi), max(k_lo, k_hi)
    rem = np.full((4,), 100, np.int32)
    acc_lo = _accepts(props, logits, dict(criterion="topk", top_k=lo))
    acc_hi = _accepts(props, logits, dict(criterion="topk", top_k=hi))
    assert np.all(~acc_lo | acc_hi)
    assert np.all(_khat(acc_lo, rem) <= _khat(acc_hi, rem))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), e1=st.floats(0.0, 8.0),
       e2=st.floats(0.0, 8.0))
def test_khat_monotone_under_tightened_distance(seed, e1, e2):
    """Tightening §5.2's distance tolerance never grows k̂."""
    props, logits = _random_case(seed, vocab=17)
    lo, hi = min(e1, e2), max(e1, e2)
    rem = np.full((4,), 100, np.int32)
    acc_lo = _accepts(props, logits, dict(criterion="distance", epsilon=lo))
    acc_hi = _accepts(props, logits, dict(criterion="distance", epsilon=hi))
    assert np.all(~acc_lo | acc_hi)
    assert np.all(_khat(acc_lo, rem) <= _khat(acc_hi, rem))
