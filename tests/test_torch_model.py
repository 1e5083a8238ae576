"""The port's model against the JAX package's on reduced qwen2-1.5b (fp32):
the same parameters (carried across by ``params_from_numpy``), the same
pages, tables and tokens.  A suffix prefill that reads a shared page, then
decode steps, through ``Engine.decode`` on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_model as jinit_model
from repro.serving.engine import Engine as JEngine
from repro_torch import configs
from repro_torch.models import init_model
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)

# fp32 on both sides; the matmuls and the attention sum in different orders
TOL = dict(atol=1e-4, rtol=1e-4)
P, MP, N = 16, 4, 9


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    jparams = jinit_model(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = configs.get_reduced("qwen2-1.5b")
    return (JEngine(jcfg, jparams, max_len=64),
            Engine(cfg, params_from_numpy(np_params), max_len=64, device="cpu"),
            np_params)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_params_from_numpy_round_trips(models):
    _, eng, np_params = models
    got = dict(_leaves(eng.params))
    want = dict(_leaves(np_params))
    assert got.keys() == want.keys()
    for name, a in want.items():
        assert got[name].dtype == torch.float32, name
        np.testing.assert_array_equal(got[name].numpy(), a, err_msg=name)
    # bf16 leaves widen exactly
    bf = params_from_numpy({"w": np.asarray(jnp.asarray(a, jnp.bfloat16))
                            for a in [want["/embed"][:4]]})
    assert bf["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["w"].float().numpy(),
        np.asarray(jnp.asarray(want["/embed"][:4], jnp.bfloat16), np.float32))


def test_init_model_tree_matches_jax(models):
    _, _, np_params = models
    ours = init_model(configs.get_reduced("qwen2-1.5b"), device="cpu")
    got = {k: tuple(v.shape) for k, v in _leaves(ours)}
    want = {k: tuple(v.shape) for k, v in _leaves(np_params)}
    assert got == want


def _run(jeng, eng, cache_np, toks, positions, n_real):
    """One Engine.decode call on both sides; compares the logits of the
    real rows (``n_real[b]`` per slot) and every page but the trash page 0.
    Returns the next numpy cache (cursors and tables as the JAX side)."""
    jcache = {"paged": {k: jnp.asarray(v) for k, v in cache_np.items()}}
    tcache = {"paged": {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}}
    jlogits, jcache = jeng.decode(jnp.asarray(toks), jnp.asarray(positions), jcache)
    tlogits, tcache = eng.decode(torch.from_numpy(toks), torch.from_numpy(positions),
                                 tcache)
    for b, n in enumerate(n_real):
        np.testing.assert_allclose(tlogits[b, :n].numpy(),
                                   np.asarray(jlogits[b, :n]), **TOL)
    for leaf in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tcache["paged"][leaf][:, 1:].numpy(),
                                   np.asarray(jcache["paged"][leaf][:, 1:]),
                                   err_msg=leaf, **TOL)
    for leaf in ("table", "pos"):
        np.testing.assert_array_equal(tcache["paged"][leaf].numpy(),
                                      np.asarray(jcache["paged"][leaf]))
    return {k: np.asarray(v) for k, v in jcache["paged"].items()}, tlogits


def test_suffix_prefill_then_decode_matches_jax(models):
    jeng, eng, _ = models
    cfg = eng.cfg
    Ln = cfg.n_layers
    rng = np.random.default_rng(0)
    shape = (Ln, N, P, cfg.n_kv_heads, cfg.hd)
    cache = {"k_pages": np.zeros(shape, np.float32),
             "v_pages": np.zeros(shape, np.float32),
             "table": np.full((Ln, 2, MP), -1, np.int32),
             "pos": np.zeros((Ln, 2), np.int32)}
    prompt0 = rng.integers(3, 90, 30).astype(np.int32)
    prompt1 = np.concatenate([prompt0[:16], rng.integers(3, 90, 5).astype(np.int32)])

    # slot 0 prefills 30 tokens (right-padded to 32) into pages 1, 2
    one = {"k_pages": cache["k_pages"], "v_pages": cache["v_pages"],
           "table": np.asarray([[[1, 2, -1, -1]]] * Ln, np.int32),
           "pos": np.zeros((Ln, 1), np.int32)}
    toks = np.zeros((1, 32), np.int32)
    toks[0, :30] = prompt0
    out, _ = _run(jeng, eng, one, toks, np.arange(32, dtype=np.int32)[None], [30])
    cache["k_pages"], cache["v_pages"] = out["k_pages"], out["v_pages"]

    # slot 1 shares page 1 (the first 16 tokens) and prefills its 5-token
    # suffix at position 16 into page 3, reading the shared page in place
    one = {"k_pages": cache["k_pages"], "v_pages": cache["v_pages"],
           "table": np.asarray([[[1, 3, -1, -1]]] * Ln, np.int32),
           "pos": np.full((Ln, 1), 16, np.int32)}
    toks = np.zeros((1, 16), np.int32)
    toks[0, :5] = prompt1[16:]
    out, _ = _run(jeng, eng, one, toks, 16 + np.arange(16, dtype=np.int32)[None], [5])
    cache["k_pages"], cache["v_pages"] = out["k_pages"], out["v_pages"]

    # 3 decode steps over both slots, both reading the shared page 1; slot
    # 0's cursor crosses into its lazily mapped page 4 at position 32
    cache["table"][:] = np.asarray([[1, 2, 4, -1], [1, 3, -1, -1]], np.int32)
    cache["pos"][:] = np.asarray([30, 21], np.int32)
    tok = np.asarray([[7], [8]], np.int32)
    for step in range(3):
        pos = cache["pos"][0].copy()
        cache, logits = _run(jeng, eng, cache, tok, pos[:, None], [1, 1])
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32).numpy()[:, None]
    assert cache["pos"][0].tolist() == [33, 24]
