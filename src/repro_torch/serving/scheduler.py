"""Continuous-batching scheduler with per-user FIFO queues + paged KV admission.

The paper's deployment funnels every request through a per-user FIFO so
responses arrive in order (§4).  This scheduler reproduces that discipline
inside the serving engine:

* one in-flight request per user at a time; later requests wait in that
  user's queue;
* a fixed pool of decode slots (the continuous batch); freed slots are
  refilled from user queues round-robin;
* admission onto the **paged** KV cache: fixed-size pages in one global
  device tensor, per-slot page tables, and a refcounted
  :class:`~repro_torch.serving.kv_cache.PagePool` with copy-on-write prefix
  sharing.  Prompts whose leading pages are already prefilled (shared
  course prompts) decode against the SAME physical pages; only the
  unmatched suffix runs through the model.  Admission is page-budgeted,
  decode pages are mapped lazily the step a slot's cursor crosses a page
  boundary, and cold prefix pages are LRU-evicted under pressure.

The page tables live on the host in numpy; the device copy (replicated over
the layer axis, as in the JAX layout) and the page pools are patched IN
PLACE where the JAX package builds updated copies.

Ported: the paged path of ``repro.serving.scheduler.Scheduler``.  The dense
path (``paged=False``) is ROADMAP (a)2, speculative decoding (``draft=``)
too; both raise ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving import discipline, kv_cache
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SamplerConfig, sample


@dataclasses.dataclass
class Request:
    rid: int
    user: str
    prompt: torch.Tensor           # (S,) int token ids
    max_new: int = 32
    eos_id: int = -1
    # latency budget in seconds from submission (None = best-effort);
    # admission serves tight budgets earliest-deadline-first
    deadline: Optional[float] = None
    # budget depletion tier (0 = fully funded): weighs against the request
    # in slot refill until the starvation guard ages it back
    tier: int = 0
    # filled during serving
    submitted_at: float = 0.0
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pos: int = 0
    done: bool = False


def _pow2_bucket(n: int, lo: int = 16) -> int:
    """Pad a length to a power of two (>= lo), as the JAX package does to
    bound its compile set; kept so both packages run the same shapes."""
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


class Scheduler:
    def __init__(self, engine: Engine, n_slots: int = 8,
                 sampler: SamplerConfig = SamplerConfig(),
                 max_len: Optional[int] = None, seed: int = 0,
                 tier_penalty: float = 0.25, starvation_s: float = 2.0,
                 paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None, prefix_cache: bool = True,
                 draft=None):
        if not paged:
            raise NotImplementedError(
                "the dense scheduler is not ported yet (ROADMAP (a)2); "
                "pass paged=True")
        if draft is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP (a)2)")
        self.engine = engine
        self.device = engine.device
        self.n_slots = n_slots
        self.sampler = sampler
        self.tier_penalty = tier_penalty
        self.starvation_s = starvation_s
        self.max_len = max_len or engine.max_len
        self.queues: Dict[str, collections.deque] = collections.defaultdict(collections.deque)
        self.user_inflight: Dict[str, bool] = collections.defaultdict(bool)
        self.slots: List[Optional[Request]] = [None] * n_slots
        # page-budgeted device memory: n_pages * page_size cache tokens; the
        # default matches a dense footprint (n_slots * max_len) + the pinned
        # trash page
        self.page_size = page_size
        self.max_pages = -(-self.max_len // page_size)
        self.n_pages = n_pages or (n_slots * self.max_pages + 1)
        self.trie = kv_cache.PrefixTrie(page_size) if prefix_cache else None
        self.pool = kv_cache.PagePool(self.n_pages, page_size,
                                      trie=self.trie, sentinel=True)
        self.cache = engine.new_paged_cache(n_slots, self.n_pages, page_size,
                                            self.max_pages)
        self._tables = np.full((n_slots, self.max_pages), -1, np.int32)
        self._slot_unreserved = np.zeros(n_slots, np.int64)
        self.tokens = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.finished: List[Request] = []
        self._rr_start = 0                # round-robin start index over users
        self._users_order: List[str] = []
        # telemetry
        self.prefill_tokens = 0           # real (unpadded) tokens prefilled
        self.shared_tokens = 0            # prompt tokens served from the trie
        self.peak_live = 0                # max concurrently admitted slots

    def _dev(self, values, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=self.device)

    # -- submission ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        if int(req.prompt.shape[0]) + 1 > self.max_len:
            # reject up front — a raise mid-admission would strand the popped
            # request and leave its user permanently marked in-flight
            raise ValueError(
                f"request {req.rid}: prompt of {int(req.prompt.shape[0])} "
                f"tokens cannot decode within max_len={self.max_len}")
        req.submitted_at = time.monotonic()
        if req.user not in self.queues:
            self._users_order.append(req.user)
        self.queues[req.user].append(req)

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values()) + \
            sum(1 for s in self.slots if s is not None)

    # -- admission -----------------------------------------------------------
    def _next_request(self) -> Optional[Request]:
        """Round-robin over users; respect one-in-flight-per-user FIFO.

        The scan start rotates past the last admitted user.  Among eligible
        users, heads with a latency ``deadline`` go earliest-deadline-first;
        each depletion ``tier`` adds ``tier_penalty`` seconds of slack, and a
        head that has waited ``starvation_s`` ages back to tier 0."""
        users = self._users_order
        eligible = []          # (rotation offset, user)
        for i in range(len(users)):
            user = users[(self._rr_start + i) % len(users)]
            if self.queues[user] and not self.user_inflight[user]:
                eligible.append((i, user))
        if not eligible:
            return None
        now = time.monotonic()

        def deadline_of(user):
            head = self.queues[user][0]
            if head.deadline is None:
                return None
            return head.submitted_at + head.deadline

        def tier_of(user):
            head = self.queues[user][0]
            if now - head.submitted_at >= self.starvation_s:
                return 0
            return head.tier

        i, user = discipline.select_rotating_head(
            eligible, deadline_of, tier_of, self.tier_penalty)
        self.user_inflight[user] = True
        self._rr_start = (self._rr_start + i + 1) % len(users)
        return self.queues[user].popleft()

    def _put_back(self, req: Request) -> None:
        """Return an un-admittable head to the front of its queue."""
        self.queues[req.user].appendleft(req)
        self.user_inflight[req.user] = False

    def _match_prefix(self, tokens: List[int]) -> Tuple[List[int], int, bool]:
        """Trie lookup: (shared physical pages, suffix start, cow).  A prompt
        fully covered by cached pages re-runs only its LAST token, whose
        write lands in the last matched page: that page is copy-on-write
        forked (``cow=True``), not shared."""
        if self.trie is None:
            return [], 0, False
        matched = self.trie.match(tokens)
        if not matched:
            return [], 0, False
        if len(matched) * self.page_size == len(tokens):
            return matched, len(tokens) - 1, True
        return matched, len(matched) * self.page_size, False

    def _admit_paged(self) -> None:
        """Page-budgeted refill against the prefix trie, in sharing waves: a
        head about to prefill a page chunk that an earlier member of the
        current wave is prefilling waits for the next wave, where the chunk
        is in the trie and is shared instead of recomputed."""
        while True:
            admitted, blocked = self._admit_wave()
            if not admitted or blocked:
                return

    def _admit_wave(self) -> Tuple[int, bool]:
        """One admission wave. Returns (n admitted, hard-blocked?)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return 0, True
        P = self.page_size
        plan = []          # (slot, req, tokens, shared, suffix_start, cow_src)
        cow_pairs: List[Tuple[int, int]] = []
        wave_chunks: set = set()
        blocked = False
        for slot in free:
            req = self._next_request()
            if req is None:
                break
            tokens = [int(t) for t in req.prompt.tolist()]
            L = len(tokens)
            # the page table is max_pages wide: cap the decode budget so the
            # write cursor stays inside it
            req.max_new = min(req.max_new, self.max_len - L)
            matched, suffix_start, cow = self._match_prefix(tokens)
            shared = matched[:-1] if cow else matched
            new_chunks = {tuple(tokens[i:i + P])
                          for i in range(len(matched) * P, L // P * P, P)}
            if new_chunks & wave_chunks:
                self._put_back(req)
                break
            # decode writes at L .. L+max_new-2 (at least one step runs)
            total_pages = -(-(L + max(req.max_new - 1, 1)) // P)
            n_new = total_pages - len(shared)
            if not self.pool.try_admit(n_new, shared):
                self._put_back(req)
                if not any(s is not None for s in self.slots) and not plan:
                    raise ValueError(
                        f"request {req.rid} needs {n_new} pages but the pool "
                        f"can never free more than {self.pool.headroom()}")
                blocked = True
                break
            wave_chunks |= new_chunks
            self._tables[slot, :len(shared)] = shared
            first_new = suffix_start // P
            n_prompt_pages = -(-L // P)
            for pi in range(first_new, n_prompt_pages):
                if cow and pi == first_new:
                    page = self.pool.cow()
                    cow_pairs.append((matched[-1], page))
                else:
                    page = self.pool.alloc_reserved()
                self._tables[slot, pi] = page
            self._slot_unreserved[slot] = n_new - (n_prompt_pages - first_new)
            self.shared_tokens += suffix_start
            plan.append((slot, req, tokens, shared, suffix_start,
                         matched[-1] if cow else -1))
        if not plan:
            return 0, blocked
        paged = self.cache["paged"]
        if cow_pairs:
            # copy-on-write forks: duplicate each shared source page into the
            # slot-private target before any write can touch it (in place)
            srcs = self._dev([s for s, _ in cow_pairs], torch.long)
            tgts = self._dev([t for _, t in cow_pairs], torch.long)
            paged["k_pages"][:, tgts] = paged["k_pages"][:, srcs]
            paged["v_pages"][:, tgts] = paged["v_pages"][:, srcs]
        self._prefill_suffixes(paged, plan)
        return len(plan), blocked

    def _prefill_suffixes(self, paged: Dict, plan) -> None:
        """ONE suffix prefill for the admitted group, directly against the
        pool: the right-padded suffix tokens run one decode-shaped model
        call that reads shared prefix pages in place and writes the suffix
        KV into the freshly allocated pages.  Pad-token writes past a
        slot's prompt go to the trash page (position on an unmapped page) or
        land past the cursor in the slot-PRIVATE partial last page — the
        trie only retains FULL prompt pages, so shared pages are never
        written."""
        P = self.page_size
        slots = [p[0] for p in plan]
        lens = [len(p[2]) for p in plan]
        starts = [p[4] for p in plan]
        suf = [l - s for l, s in zip(lens, starts)]
        S = min(_pow2_bucket(max(suf)), max(self.max_len, max(suf)))
        B = len(plan)
        Ln = paged["pos"].shape[0]
        tbl_rows = self._dev(self._tables[slots])                   # (B, MP)
        starts_dev = self._dev(starts)
        view = {"paged": {
            "k_pages": paged["k_pages"], "v_pages": paged["v_pages"],
            "table": tbl_rows[None].repeat(Ln, 1, 1),
            "pos": starts_dev[None].repeat(Ln, 1)}}
        toks = np.zeros((B, S), np.int32)
        for b, p in enumerate(plan):
            toks[b, :suf[b]] = p[2][p[4]:]
        positions = starts_dev[:, None] + torch.arange(S, dtype=torch.int32,
                                                       device=self.device)[None]
        logits, _ = self.engine.decode(self._dev(toks), positions, view)
        self.prefill_tokens += sum(suf)
        sl = self._dev(slots, torch.long)
        paged["table"][:, sl, :] = tbl_rows[None]
        paged["pos"][:, sl] = self._dev(lens)[None]
        # register every full prompt page for future sharing (one trie
        # retention ref per newly inserted page)
        if self.trie is not None:
            for slot, _req, tokens, _sh, _st, _cw in plan:
                chain = [int(p) for p in self._tables[slot, :len(tokens) // P]]
                for page in self.trie.insert(tokens, chain):
                    self.pool.retain_in_trie(page)
        # ONE vectorized argmax + ONE host transfer for the first tokens
        last = self._dev([l - 1 - st for l, st in zip(lens, starts)], torch.long)
        firsts = torch.argmax(
            logits[torch.arange(B, device=self.device), last], dim=-1).to(torch.int32)
        self.tokens[sl] = firsts
        for (slot, req, tokens, _sh, _st, _cw), first in zip(plan, firsts.tolist()):
            req.slot = slot
            req.pos = len(tokens)
            req.generated = [first]
            self.slots[slot] = req
        self.peak_live = max(self.peak_live,
                             sum(1 for s in self.slots if s is not None))

    def _map_decode_pages(self) -> None:
        """Lazily map the page each live slot's cursor writes next, out of
        its admission reservation (so it cannot fail); the device table is
        patched with ONE in-place scatter."""
        upd: List[Tuple[int, int, int]] = []       # (slot, logical, physical)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            pi = req.pos // self.page_size
            if self._tables[slot, pi] < 0:
                page = self.pool.alloc_reserved()
                self._slot_unreserved[slot] -= 1
                assert self._slot_unreserved[slot] >= 0
                self._tables[slot, pi] = page
                upd.append((slot, pi, page))
        if upd:
            s, li, pg = (self._dev([u[i] for u in upd], torch.long) for i in range(3))
            self.cache["paged"]["table"][:, s, li] = pg.to(torch.int32)[None]

    # -- one decode step over the whole batch --------------------------------
    def step(self) -> List[Request]:
        self._admit_paged()
        live = [s for s in self.slots if s is not None]
        if not live:
            return []
        self.peak_live = max(self.peak_live, len(live))
        self._map_decode_pages()
        positions = self._dev([[s.pos if s is not None else 0] for s in self.slots])
        logits, self.cache = self.engine.decode(self.tokens[:, None], positions,
                                                self.cache)
        nxt = sample(logits[:, -1], self.generator, self.sampler)

        done_now: List[Request] = []
        keep: List[int] = []
        for slot, tok in enumerate(nxt.tolist()):
            req = self.slots[slot]
            if req is None:
                continue
            req.generated.append(tok)
            req.pos += 1
            if tok == req.eos_id or len(req.generated) >= req.max_new:
                req.done = True
                done_now.append(req)
                self.slots[slot] = None
                self.user_inflight[req.user] = False
            else:
                keep.append(slot)
        if keep:
            kept = self._dev(keep, torch.long)
            self.tokens[kept] = nxt[kept]
        if done_now:
            self._teardown([r.slot for r in done_now])
        self.finished.extend(done_now)
        return done_now

    def cancel(self, rid: int) -> bool:
        """Abort a request: a live slot is torn down at once (pages and
        reservation back to the pool) and the user's in-flight mark is
        cleared; a queued request is removed.  The partial ``generated`` is
        kept on the request.  False for an unknown / finished rid."""
        for slot, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                req.done = True
                self.slots[slot] = None
                self.user_inflight[req.user] = False
                self._teardown([slot])
                self.finished.append(req)
                return True
        for q in self.queues.values():
            for r in list(q):
                if r.rid == rid:
                    q.remove(r)
                    return True
        return False

    def _teardown(self, slots: List[int]) -> None:
        """Release every finished slot's pages and reservation to the pool
        and reset its table row and cursor on the device in place."""
        for slot in slots:
            pages = self._tables[slot][self._tables[slot] >= 0]
            self.pool.release(pages.tolist(), int(self._slot_unreserved[slot]))
            self._tables[slot] = -1
            self._slot_unreserved[slot] = 0
        paged = self.cache["paged"]
        sl = self._dev(slots, torch.long)
        paged["table"][:, sl, :] = -1
        paged["pos"][:, sl] = 0

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if self.pending() == 0:
                break
            self.step()
        return self.finished
