"""The port's paged continuous-batching Scheduler against the JAX package's
paged Scheduler: same weights, same requests, equal greedy tokens and
telemetry.  Tokens are compared path by path (paged against paged)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_model as jinit_model
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import configs
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import Request, Scheduler

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    jparams = jinit_model(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get_reduced("qwen2-1.5b")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return JEngine(jcfg, jparams, max_len=64), Engine(cfg, params, max_len=64,
                                                      device="cpu")


def _prompts_with_overlap(n, shared_len, tail_len, seed=0):
    """n prompts (numpy) sharing a ``shared_len``-token prefix with distinct
    tails."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(3, 90, shared_len).tolist()
    return [np.asarray(shared + rng.integers(3, 90, tail_len).tolist(), np.int32)
            for _ in range(n)]


def _serve_both(engines, waves, **sched_kw):
    """Serve ``waves`` (lists of (rid, user, prompt, max_new)) on both
    packages' paged schedulers, each wave run to completion before the
    next is submitted.  Returns the two schedulers."""
    jeng, eng = engines
    jsch = JScheduler(jeng, paged=True, **sched_kw)
    sch = Scheduler(eng, paged=True, **sched_kw)
    for wave in waves:
        for rid, user, prompt, max_new in wave:
            jsch.submit(JRequest(rid=rid, user=user, prompt=jnp.asarray(prompt),
                                 max_new=max_new))
            sch.submit(Request(rid=rid, user=user, prompt=torch.from_numpy(prompt),
                               max_new=max_new))
        jsch.run_to_completion()
        sch.run_to_completion()
    return jsch, sch


def _generated(sch):
    return {r.rid: [int(t) for t in r.generated] for r in sch.finished}


def test_shared_prefix_tokens_match_jax(engines):
    prompts = _prompts_with_overlap(6, shared_len=32, tail_len=6)
    wave = [(i, f"u{i}", p, 5) for i, p in enumerate(prompts)]
    jsch, sch = _serve_both(engines, [wave], n_slots=6, page_size=16)
    assert len(sch.finished) == 6
    assert _generated(sch) == _generated(jsch)
    assert sch.shared_tokens == jsch.shared_tokens >= 5 * 32
    assert sch.prefill_tokens == jsch.prefill_tokens
    assert sch.peak_live == jsch.peak_live
    sch.pool.check()


def test_full_prompt_match_cow_matches_jax(engines):
    """A prompt fully covered by cached pages reruns only its last token
    through a copy-on-write fork of the boundary page."""
    prompt = _prompts_with_overlap(1, shared_len=32, tail_len=0)[0]
    waves = [[(0, "a", prompt, 4)], [(1, "b", prompt, 4)]]
    jsch, sch = _serve_both(engines, waves, n_slots=2, page_size=16)
    got = _generated(sch)
    assert got == _generated(jsch)
    assert got[0] == got[1]
    assert sch.pool.n_cow == jsch.pool.n_cow >= 1
    assert sch.shared_tokens == jsch.shared_tokens >= 31
    sch.pool.check()


def test_lazy_decode_page_allocation_matches_jax(engines):
    """Decode pages are mapped the step the cursor crosses a page boundary,
    not at admission."""
    jeng, eng = engines
    prompt = np.arange(10, dtype=np.int32) + 3
    sch = Scheduler(eng, n_slots=1, paged=True, page_size=16)
    sch.submit(Request(rid=0, user="a", prompt=torch.from_numpy(prompt), max_new=12))
    sch.step()                       # admit + first decode (pos 10 -> 11)
    assert sch._tables[0, 0] >= 0
    assert sch._tables[0, 1] == -1, "decode page mapped eagerly"
    while sch.slots[0] is not None and sch.slots[0].pos < 17:
        sch.step()
    assert sch._tables[0, 1] >= 0, "page not mapped at boundary"
    sch.run_to_completion()
    jsch = JScheduler(jeng, n_slots=1, paged=True, page_size=16)
    jsch.submit(JRequest(rid=0, user="a", prompt=jnp.asarray(prompt), max_new=12))
    jsch.run_to_completion()
    assert _generated(sch) == _generated(jsch)
    sch.pool.check()


def test_eviction_under_pressure_matches_jax(engines):
    """Cold trie-retained prefix pages are LRU-evicted when the pool runs
    dry; tokens and eviction counts stay those of the reference."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, 90, 16).astype(np.int32) for _ in range(8)]
    wave = [(i, "solo", p, 4) for i, p in enumerate(prompts)]
    jsch, sch = _serve_both(engines, [wave], n_slots=2, page_size=8,
                            n_pages=2 * 8 + 1)
    assert len(sch.finished) == 8
    assert _generated(sch) == _generated(jsch)
    assert sch.pool.n_evictions == jsch.pool.n_evictions > 0
    sch.pool.check()


def test_fifo_and_cancel(engines):
    """One in-flight request per user, in submission order; a cancelled
    live request releases its pages."""
    _, eng = engines
    sch = Scheduler(eng, n_slots=3, paged=True, page_size=16)
    for i in range(7):
        sch.submit(Request(rid=i, user=f"u{i % 2}", max_new=4,
                           prompt=torch.arange(4 + i, dtype=torch.int32) + 3))
    sch.step()
    live = [s.rid for s in sch.slots if s is not None]
    assert sch.cancel(live[0])
    assert sch.cancel(6)                       # still queued
    assert not sch.cancel(99)
    done = sch.run_to_completion()
    assert len(done) == 6
    for user in ("u0", "u1"):
        rids = [r.rid for r in done if r.user == user and r.rid != live[0]]
        assert rids == sorted(rids), "per-user FIFO violated"
    assert sch.pool.used() - sch.pool.evictable() == 1   # only the trash page
    sch.pool.check()


def test_unported_paths_raise(engines):
    _, eng = engines
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Scheduler(eng)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Scheduler(eng, paged=True, draft=object())


def test_sampler_greedy_first_index_on_ties_and_topk():
    logits = np.asarray([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]], np.float32)
    got = sample(torch.from_numpy(logits), None, SamplerConfig())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(logits, -1)))
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    draws = sample(logits, gen, SamplerConfig(temperature=1.0, top_k=3))
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert bool((top3 == draws[:, None].long()).any(dim=-1).all())
