#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each raises on failure and nothing is caught:

1. Print the card's name and power limit; build the CUDA kernels from the
   sources in this checkout (``build/``).
2. Hold each kernel against its plain PyTorch version on the card, at the
   full-width qwen2-1.5b attention shapes (Hq=12, Hkv=2, D=128, P=16), with
   and without window / softcap, in fp32 (TF32 off) and bf16; time the
   kernel, the plain version, and ``scaled_dot_product_attention`` over the
   already-gathered dense K/V as a yardstick (gather excluded; the port
   never calls it).
3. Serve shared-prefix requests through the paged ``Scheduler`` on reduced
   qwen2-1.5b in fp32, on the CPU and on the card, from the same weights:
   the greedy tokens must be equal.
4. Serve 8 course-style prompts through the paged ``Scheduler`` on
   full-width qwen2-1.5b in bf16 (random weights from a seeded generator)
   and print the serving numbers.  The kernels' launch counters are set to
   0 just before this run and read just after.

Then one JSON line per the kernels, the card line, and the result line.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances, kernel against plain version on the same inputs.
# fp32: both accumulate in fp32, in different orders (online softmax across
# pages against one softmax over the gathered cache).
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16: both compute in fp32 from the same bf16 inputs and round once to
# bf16 at the end; values that straddle a rounding boundary land one bf16
# ulp apart, and one ulp is at most 2**-7 of the value.
BF16_TOL = dict(atol=1e-5, rtol=2 ** -7)

# BOS + a 47-byte preamble fill three 16-token pages; with questions of at
# most 16 bytes every prompt fits the 64 ids the adapter keeps
PREAMBLE = "CS 162 OS course TA bot. Answer in one line. Q:"
QUESTIONS = ["What is a TLB?", "Why use paging?", "What is a trap?",
             "Define a thread.", "What is a lock?", "Why use a heap?",
             "What is fork()?", "What's a page?"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
N_PAGES, P, MP, HQ, HKV, D = 65, 16, 8, 12, 2, 128


def paged_case(pos, S: int, dtype, seed: int):
    """Random pages and queries for slots at cursors ``pos``.  Every slot
    shares the first three physical pages (a trie-shared preamble, as on
    the main path) and maps private pages after them up to its live count;
    the table tail is -1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(pos)
    shape = (N_PAGES, P, HKV, D)
    k = torch.randn(shape, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape, generator=g, device="cuda").to(dtype)
    q = torch.randn((B, S, HQ, D), generator=g, device="cuda").to(dtype)
    table = torch.full((B, MP), -1, dtype=torch.int32)
    nxt = 4
    for b, p in enumerate(pos):
        for pi in range((p + S - 1) // P + 1):
            if pi < 3:
                table[b, pi] = 1 + pi
            else:
                table[b, pi] = nxt
                nxt += 1
    assert nxt <= N_PAGES
    pos_t = torch.tensor(pos, dtype=torch.int32)
    return q, k, v, table.cuda(), pos_t.cuda()


def visible_keys(pos, S: int, window: int):
    """Per query row, how many key positions it attends to."""
    out = []
    for p in pos:
        for j in range(S):
            qpos = p + j
            out.append(qpos + 1 if window <= 0 else min(qpos + 1, window))
    return out


def bound(q, k, table, pos, S: int):
    """(bound_ms, bound_by): the larger of the bytes that must move (q and
    out once, each distinct live (page, KV head) of K and V once, table,
    pos) over HBM bandwidth, and the multiply-adds these positions need
    over the peak rate of the input type."""
    elt = q.element_size()
    tbl = table.cpu().tolist()
    live = set()
    for b, p in enumerate(pos):
        n = min((p + S - 1) // P + 1, MP)
        live.update(max(t, 0) for t in tbl[b][:n])
    nbytes = (2 * q.numel() * elt + 2 * len(live) * P * HKV * D * elt
              + table.numel() * 4 + len(pos) * 4)
    flops = 4.0 * D * HQ * sum(visible_keys(pos, S, 0))
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_dense(q, k_pages, v_pages, table, pos, S: int):
    """Yardstick inputs: dense (B, H, T, D) K/V gathered once from the pages
    and a boolean causal mask; returns the SDPA call alone."""
    B = q.shape[0]
    T = MP * P
    kd = k_pages[table.clamp(min=0).long()].reshape(B, T, HKV, D).transpose(1, 2)
    vd = v_pages[table.clamp(min=0).long()].reshape(B, T, HKV, D).transpose(1, 2)
    qd = q.transpose(1, 2)                                       # (B, Hq, S, D)
    qpos = pos.long()[:, None] + torch.arange(S, device="cuda")[None]
    mask = torch.arange(T, device="cuda")[None, None, :] <= qpos[:, :, None]
    mask = mask[:, None]                                         # (B, 1, S, T)
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                  enable_gqa=True)


def check_kernels(ops, ref):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # main-path shapes: decode over 8 slots at mixed live lengths; prefill of
    # the 7 suffixes of 16 after the 48-token shared preamble
    decode_pos = [47, 50, 55, 60, 63, 64, 80, 95]
    prefill_pos, prefill_s = [48] * 7, 16
    variants = [(0, 0.0), (24, 30.0)]
    results = {}
    for name, wrapper, plain, pos_list, S in (
            ("paged_decode_attention", ops.paged_decode_attention,
             ref.paged_decode_attention_ref, decode_pos, 1),
            ("paged_prefill_attention", ops.paged_prefill_attention,
             ref.paged_prefill_attention_ref, prefill_pos, prefill_s),
            # a deeper, mixed prefill block for correctness only
            ("paged_prefill_attention", ops.paged_prefill_attention,
             ref.paged_prefill_attention_ref, [0, 5, 16, 17, 31, 40, 48, 60], 64)):
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            for window, softcap in variants:
                q, k, v, table, pos = paged_case(pos_list, S, dtype, seed=S)
                qq = q[:, 0].contiguous() if S == 1 else q
                got = wrapper(qq, k, v, table, pos, window, softcap)
                want = plain(qq, k, v, table, pos, window, softcap)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                torch.testing.assert_close(got.float(), want.float(), **tol)
                print(f"  {name} S={S} B={len(pos_list)} {str(dtype)[6:]} "
                      f"window={window} softcap={softcap}: max_abs_err={err:.3e} ok")
                if window or dtype != torch.bfloat16 or name in results:
                    continue
                kernel_ms = time_ms(lambda: wrapper(qq, k, v, table, pos, 0, 0.0))
                plain_ms = time_ms(lambda: plain(qq, k, v, table, pos, 0, 0.0))
                library_ms = time_ms(sdpa_dense(q, k, v, table, pos, S))
                bound_ms, bound_by = bound(q, k, table, pos_list, S)
                results[name] = dict(
                    shape=f"B={len(pos_list)} S={S} Hq={HQ} Hkv={HKV} D={D} P={P} "
                          f"MP={MP} bf16", max_abs_err=err, ms=kernel_ms,
                    plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
                print(f"  {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"sdpa on gathered K/V (gather excluded) {library_ms:.4f} ms, "
                      f"bound {bound_ms:.5f} ms ({bound_by})")
    return results


# --------------------------------------------------------------------------
# phases 3 and 4: the paged serving path
# --------------------------------------------------------------------------
def serve(engine, prompts, max_new: int, n_slots: int):
    from repro_torch.serving.scheduler import Request, Scheduler
    sched = Scheduler(engine, n_slots=n_slots, paged=True, page_size=16,
                      prefix_cache=True)
    for i, ids in enumerate(prompts):
        sched.submit(Request(rid=i, user=f"student{i}", max_new=max_new,
                             prompt=torch.tensor(ids, dtype=torch.int32)))
    return sched


def check_slice(ops):
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import init_model
    from repro_torch.serving.engine import Engine

    cfg = configs.get_reduced("qwen2-1.5b")
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    shared = rng.integers(3, 90, 32).tolist()
    prompts = [shared + rng.integers(3, 90, 6).tolist() for _ in range(6)]
    tokens = {}
    for device in ("cpu", "cuda"):
        ops.paged_decode_attention.launches = 0
        ops.paged_prefill_attention.launches = 0
        sched = serve(Engine(cfg, params, max_len=64, device=device), prompts, 8, 6)
        done = sched.run_to_completion()
        assert len(done) == 6 and sched.shared_tokens >= 5 * 32
        sched.pool.check()
        tokens[device] = {r.rid: r.generated for r in done}
    assert ops.paged_decode_attention.launches > 0
    assert ops.paged_prefill_attention.launches > 0
    assert tokens["cpu"] == tokens["cuda"], (tokens["cpu"], tokens["cuda"])
    print(f"  reduced qwen2-1.5b fp32: CPU and card tokens equal for 6 requests "
          f"x 8 tokens; launches decode={ops.paged_decode_attention.launches} "
          f"prefill={ops.paged_prefill_attention.launches}")


def full_width(ops):
    from repro_torch import configs
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import init_model
    from repro_torch.serving.engine import Engine

    cfg = configs.get("qwen2-1.5b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_model(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    print(f"  weights: {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
          f"params in bf16, made on the card in {time.perf_counter() - t0:.1f} s")
    engine = Engine(cfg, params, max_len=128, device="cuda")
    tok = ByteTokenizer()
    prompts = [tok.encode(PREAMBLE + q)[-64:] for q in QUESTIONS]

    warm = serve(engine, prompts[:2], 2, 2)      # cuBLAS / allocator warm-up
    warm.run_to_completion()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.paged_decode_attention.launches = 0
    ops.paged_prefill_attention.launches = 0
    sched = serve(engine, prompts, 32, 8)
    t0 = time.perf_counter()
    sched.step()                                 # admission + prefill + decode 1
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    step_s, step_tokens = [], 0
    while sched.pending():
        live = sum(s is not None for s in sched.slots)
        t = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_tokens += live
    launches = {"paged_decode_attention": ops.paged_decode_attention.launches,
                "paged_prefill_attention": ops.paged_prefill_attention.launches}
    peak = torch.cuda.max_memory_allocated()

    done = sched.finished
    assert len(done) == 8 and all(len(r.generated) == 32 for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.generated)
    sched.pool.check()
    assert sched.shared_tokens > 0
    assert all(n > 0 for n in launches.values()), launches

    # logits of request 0's prompt through a fresh cache: finite, of the
    # expected shape, and their argmax is the first token the scheduler gave
    # (right-padded to 64 as the scheduler's first wave ran it)
    L0 = len(prompts[0])
    ids = torch.zeros((1, 64), dtype=torch.int32)
    ids[0, :L0] = torch.tensor(prompts[0], dtype=torch.int32)
    cache = engine.new_paged_cache(1, 6, 16, 8)
    cache["paged"]["table"][:, 0, :-(-L0 // 16)] = torch.arange(
        1, 1 - (-L0 // 16), dtype=torch.int32)
    pos = torch.arange(64, dtype=torch.int32, device="cuda")[None]
    logits, _ = engine.decode(ids.cuda(), pos, cache)
    assert logits.shape == (1, 64, cfg.vocab)
    assert bool(torch.isfinite(logits[0, :L0]).all())
    first = next(r for r in done if r.rid == 0).generated[0]
    assert int(torch.argmax(logits[0, L0 - 1])) == first

    serving = dict(
        decode_tokens_per_s=step_tokens / sum(step_s),
        ms_per_decode_step=statistics.median(step_s) * 1e3,
        ttft_first_wave_ms=ttft * 1e3,
        max_memory_allocated_bytes=peak,
        prefill_tokens=sched.prefill_tokens, shared_tokens=sched.shared_tokens,
        decode_steps=len(step_s), launches=launches)
    print("  full-width qwen2-1.5b bf16, 8 slots, 8 prompts x 32 new tokens: "
          + json.dumps(serving))
    profile_decode(engine, prompts, serving["ms_per_decode_step"])
    return launches


def profile_decode(engine, prompts, step_ms: float, n_steps: int = 3):
    """Where a full-width decode step's time goes: device time by kernel
    over ``n_steps`` decode steps of 8 live slots, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sched = serve(engine, prompts, 32, 8)
    sched.step()                                 # admission + first decode
    sched.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            sched.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps
    per_step = sum(e.count for e in kernels) / n_steps
    print(f"  profile of {n_steps} decode steps: device kernel time {device_ms:.3f} "
          f"ms/step over {per_step:.0f} kernels/step; against the unprofiled "
          f"{step_ms:.3f} ms step the device is busy {device_ms / step_ms:.1%}")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:8]:
        print(f"    {e.self_device_time_total / 1e3 / n_steps:8.3f} ms/step "
              f"{e.count / n_steps:6.0f}/step  {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops, ref

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"  nvcc {name}:\n" + "\n".join("    " + ln for ln in log.splitlines()))

    print("phase 2: kernels against their plain versions on the card")
    results = check_kernels(ops, ref)

    print("phase 3: reduced qwen2-1.5b, paged Scheduler, CPU against the card")
    check_slice(ops)

    print("phase 4: full-width qwen2-1.5b, paged Scheduler on the card")
    launches = full_width(ops)

    src = "src/repro_torch/kernels/decode_attention/csrc/paged_attention.cu"
    replaces = {
        "paged_decode_attention":
            "src/repro/kernels/decode_attention/kernel.py:195",
        "paged_prefill_attention":
            "src/repro/kernels/decode_attention/kernel.py:310"}
    kernels = []
    for name, r in results.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces[name], launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            kernel_ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"], shape=r["shape"]))
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
