"""The port's plain paged-attention versions against the JAX package's
oracles and its Pallas kernels (interpret mode), on the same numpy inputs,
in fp32 at atol = rtol = 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as jkernel
from repro.kernels.decode_attention import ref as jref
from repro_torch.kernels.decode_attention import ops, ref

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
N, P, HKV, G, D, MP = 24, 4, 2, 2, 16, 6
# cursors at and around page boundaries (P = 4), one deep enough that only
# the window sees part of its history
POS = np.asarray([0, 3, 4, 9, 13], np.int32)


def _inputs(S: int, seed: int = 0):
    """Pages, tables and queries for len(POS) slots.  Each slot maps exactly
    the pages holding positions <= pos + S - 1; the entries past that live
    count are -1, except in slot 1, whose tail holds a real page that must
    not be read (the kernel stops at the live count).  Slots 2 and 3 share
    their first physical page, as trie-shared prefixes do."""
    rng = np.random.default_rng(seed)
    B = len(POS)
    k = rng.standard_normal((N, P, HKV, D)).astype(np.float32)
    v = rng.standard_normal((N, P, HKV, D)).astype(np.float32)
    q = rng.standard_normal((B, S, HKV * G, D)).astype(np.float32)
    table = np.full((B, MP), -1, np.int32)
    free = list(rng.permutation(np.arange(1, N)))
    for b, p in enumerate(POS):
        for pi in range((p + S - 1) // P + 1):
            table[b, pi] = free.pop()
    table[3, 0] = table[2, 0]
    live1 = (POS[1] + S - 1) // P + 1
    if live1 < MP:
        table[1, live1] = free.pop()
    return q, k, v, table, POS.copy()


CASES = [(S, window, softcap) for S in (1, 3, 8)
         for window in (0, 5) for softcap in (0.0, 2.0)]


@pytest.mark.parametrize("S,window,softcap", CASES)
def test_plain_versions_match_jax(S, window, softcap):
    q, k, v, table, pos = _inputs(S, seed=S)
    tq, tk, tv, tt, tp = map(torch.from_numpy, (q, k, v, table, pos))
    if S == 1:
        got = ref.paged_decode_attention_ref(tq[:, 0], tk, tv, tt, tp, window, softcap)
        args = (jnp.asarray(q[:, 0]), k, v, table, pos)
        want_ref = jref.paged_decode_attention_ref(*args, window, softcap=softcap)
        want_pallas = jkernel.paged_decode_attention_pallas(
            *args, window=window, softcap=softcap, interpret=True)
    else:
        got = ref.paged_prefill_attention_ref(tq, tk, tv, tt, tp, window, softcap)
        args = (q, k, v, table, pos)
        want_ref = jref.paged_prefill_attention_ref(*args, window, softcap=softcap)
        want_pallas = jkernel.paged_prefill_attention_pallas(
            *args, window=window, softcap=softcap, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)


@pytest.mark.parametrize("S", [1, 3])
def test_wrapper_takes_the_plain_version_on_cpu_without_counting(S):
    q, k, v, table, pos = map(torch.from_numpy, _inputs(S))
    before = (ops.paged_decode_attention.launches,
              ops.paged_prefill_attention.launches)
    if S == 1:
        got = ops.paged_decode_attention(q[:, 0], k, v, table, pos, window=5)
        want = ref.paged_decode_attention_ref(q[:, 0], k, v, table, pos, 5)
    else:
        got = ops.paged_prefill_attention(q, k, v, table, pos, window=5)
        want = ref.paged_prefill_attention_ref(q, k, v, table, pos, 5)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (ops.paged_decode_attention.launches,
            ops.paged_prefill_attention.launches) == before


def test_wrapper_raises_on_a_device_without_a_kernel():
    q, k, v, table, pos = (torch.from_numpy(a).to("meta") for a in _inputs(1))
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_decode_attention(q[:, 0], k, v, table, pos)
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_prefill_attention(q, k, v, table, pos)
