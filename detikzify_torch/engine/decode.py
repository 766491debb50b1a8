"""Continuous-batching decode engine with tree-prefix KV reuse
(counterpart of ``detikzify_tpu/engine/decode.py`` with ``speculate=0``).

  * a fixed pool of **slots** over a PAGED KV cache: one shared page pool
    read through per-slot page tables; rollouts join and leave mid-flight
    and all slots advance together;
  * **block decoding**: ``decode_block`` zero-copy decode steps per
    ``step()``; slots that hit EOS mid-block freeze (their writes divert to
    the trash page, they re-emit EOS, their position stops);
  * **fused start**: prefix restore + bucketed paged prefill + first-token
    sampling per wave; starts are **lazy** (first tokens are fetched at the
    next ``step()``/``flush()``);
  * **O(1) prefix store**: storing a prefix pins the slot's pool pages (+ at
    most one boundary-page copy); restoring splices them into the new slot's
    table (+ at most one copy-on-write boundary page);
  * sampling on the device.

Per-slot token/position state lives on the device; the host keeps plain-int
mirrors updated from fetched results. The host-side page accounting is the
JAX engine's, line for line. Not ported here: speculative decoding, the
gather/scatter decode views and the attention-backend pin (see ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DetikzifyConfig
from ..models import detikzify, llama
from ..models.detikzify import Params
from ..ops.sampling import SamplingParams, sample

BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int, max_len: int) -> int:
    for b in BUCKETS:
        if n <= b and b <= max_len:
            return b
    return max_len


@dataclasses.dataclass
class StoredPrefix:
    """Page-table prefix: KV lives in the engine's shared page pool.

    ``pages[i]`` holds cache rows [i*page, (i+1)*page); pages are immutable
    once written (copy-on-write), so a child prefix REUSES its ancestor's
    full pages and only the tail beyond the shared page boundary is copied."""

    pages: Tuple[int, ...]     # page-pool ids, in order
    length: int                # valid tokens
    token_ids: tuple           # full token prefix (host copy, exact match)
    namespace: object = None   # scope (e.g. per-image); prevents cross-matches
    dropped: bool = False      # set on eviction: pages may be recycled


@dataclasses.dataclass
class Rollout:
    """Host-side state of one active generation."""

    slot: int
    prompt_len: int                      # tokens already in cache at start
    token_ids: List[int]                 # full sequence incl. prompt
    max_new_tokens: int
    on_token: Optional[Callable[[int], None]] = None
    new_tokens: int = 0
    finished: bool = False
    finish_reason: Optional[str] = None  # "eos" | "length" | "abort"
    aborted: bool = False

    @property
    def length(self) -> int:
        return len(self.token_ids)


class DecodeEngine:
    def __init__(
        self,
        params: Params,
        cfg: DetikzifyConfig,
        *,
        num_slots: int = 8,
        max_len: Optional[int] = None,
        cache_dtype=torch.bfloat16,
        sampling: SamplingParams = SamplingParams(),
        eos_token_id: Optional[int] = None,
        prefix_budget_bytes: int = 2 << 30,
        decode_block: int = 16,
        page_size: int = 128,
        device="cuda",
        seed: int = 0,
    ):
        """All engine state (page pool, page tables, per-slot tokens and
        positions, the sampling generator seeded with ``seed``) lives on
        ``device``; ``params`` must already be there."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DecodeEngine: no CUDA device; pass "
                               "device='cpu' to run the plain versions")
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}")
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.decode_block = decode_block
        self.page = page_size
        # the last cache row is the trash row for frozen/inactive slots'
        # writes; rows are padded to a whole number of pages
        want = (max_len or cfg.model_max_length) + 1
        self.max_len = -(-want // page_size) * page_size
        self._trash_start = self.max_len - 1
        self._m_cap = self.max_len // page_size   # pages per full slot
        self.sampling = sampling
        self.eos_token_id = (cfg.eos_token_id if eos_token_id is None
                             else eos_token_id)
        # --- paged KV: ONE page pool; slots and stored prefixes both hold
        # pool pages through page tables. The last pool page is a shared
        # TRASH page: rows at/beyond ``_trash_start`` write there, never
        # through a (possibly stale) table.
        tcfg = cfg.text
        page_bytes = (2 * tcfg.num_hidden_layers * page_size
                      * tcfg.num_key_value_heads * tcfg.head_dim
                      * torch.finfo(cache_dtype).bits // 8)
        budget_pages = int(min(max(prefix_budget_bytes // page_bytes, 2),
                               4096))
        n_pages = num_slots * self._m_cap + budget_pages + 1
        self._trash_page = n_pages - 1
        dev = self.device
        self.cache = llama.init_paged_cache(cfg.text, n_pages, page_size,
                                            cache_dtype, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self._tab_dev = torch.full((num_slots, self._m_cap),
                                   self._trash_page, dtype=torch.int32,
                                   device=dev)
        # host-side page accounting
        self._page_refs = np.zeros((n_pages,), np.int32)
        self._free_pages: List[int] = list(range(n_pages - 1))
        self._tables = np.full((num_slots, self._m_cap), self._trash_page,
                               np.int32)
        self._table_live = np.zeros((num_slots,), bool)
        self._shared_n = np.zeros((num_slots,), np.int32)  # immutable-page
                                                           # count per table
        self._rollouts: Dict[int, Rollout] = {}
        self._free_slots = list(range(num_slots))
        # device-resident per-slot state
        self._tok_dev = torch.zeros((num_slots,), dtype=torch.int32,
                                    device=dev)
        self._pos_dev = torch.zeros((num_slots,), dtype=torch.int32,
                                    device=dev)
        self._active = np.zeros((num_slots,), bool)       # host-controlled
        # per-slot (temperature, top_p, top_k), uploaded per dispatch
        self._samp_host = np.tile(
            np.asarray([sampling.temperature, sampling.top_p,
                        float(sampling.top_k)], np.float32),
            (num_slots, 1))
        self._first_pending: Dict[int, torch.Tensor] = {}  # slot -> dev scalar
        self._prefix_store: Dict[object, StoredPrefix] = {}
        self._prefix_lru: List[object] = []
        # O(1)-ish longest-prefix lookup: (namespace, length, hash(ids))
        # -> store key, plus the stored lengths per namespace
        self._prefix_index: Dict[tuple, object] = {}
        self._ns_lengths: Dict[object, Dict[int, int]] = {}

        self.counters = {"starts": 0, "start_dispatches": 0,
                         "prefix_starts": 0,
                         "decode_dispatches": 0, "decode_steps": 0,
                         "decode_tokens": 0,
                         "prefix_saves": 0, "prefill_tokens": 0,
                         "prefill_tokens_saved": 0,
                         # pool WRITE rows per start (copy-on-write boundary
                         # + tail) and boundary rows copied on store
                         "restore_cow_rows": 0, "prefix_copy_rows": 0}

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------

    def _put(self, x, dtype=torch.int32) -> torch.Tensor:
        """Host array -> tensor on the engine's device."""
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

    def _samp_cols(self, samp: torch.Tensor):
        return dict(temperature=samp[:, 0], top_p=samp[:, 1],
                    top_k=samp[:, 2].to(torch.int32))

    @torch.inference_mode()
    def _start_wave(self, slots, ids, image_embeds, starts, seq_lens,
                    img_offsets, read_tab, write_tab, cow, samp):
        """Fused start for B rollouts: install the wave's page tables,
        paged prefill (gathered prefix + tail/COW write-back into pool
        pages), and first-token sampling. The pool is updated in place."""
        b = slots.shape[0]
        self._tab_dev[slots.long()] = write_tab
        logits, _ = detikzify.prefill_paged(
            self.params, self.cfg, ids, image_embeds, starts, seq_lens,
            self.cache, read_tab, write_tab, cow, image_offsets=img_offsets,
            trash_row=self._trash_start, trash_page=self._trash_page)
        firsts = sample(logits, self.generator, **self._samp_cols(samp),
                        banned_tokens=self._banned(),
                        suppress_begin_tokens=self._suppress(),
                        is_first=torch.ones((b,), dtype=torch.bool,
                                            device=self.device))
        self._tok_dev[slots.long()] = firsts
        self._pos_dev[slots.long()] = starts + seq_lens
        return firsts

    @torch.inference_mode()
    def _decode_many(self, active: torch.Tensor, samp: torch.Tensor, k: int,
                     kv_pages: int) -> torch.Tensor:
        """k zero-copy decode steps for all slots; returns tokens [k, S].
        Slots that emit EOS freeze: their writes divert to the trash page
        (position max_len - 1), they re-emit EOS and stop advancing."""
        eos, max_len = self.eos_token_id, self.max_len
        tokens, positions = self._tok_dev, self._pos_dev
        done = ~active | (tokens == eos)
        cols = self._samp_cols(samp)
        out = []
        for _ in range(k):
            write_pos = torch.where(done, torch.full_like(positions,
                                                          max_len - 1),
                                    positions.clamp(max=max_len - 1))
            logits, _ = detikzify.decode_step_paged(
                self.params, self.cfg, tokens, write_pos, self.cache,
                self._tab_dev, kv_pages=kv_pages,
                trash_row=self._trash_start, trash_page=self._trash_page)
            nxt = sample(logits, self.generator, **cols,
                         banned_tokens=self._banned(),
                         suppress_begin_tokens=self._suppress(),
                         is_first=None)
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            positions = torch.where(done, positions, positions + 1)
            done = done | (nxt == eos)
            tokens = nxt
            out.append(nxt)
        self._tok_dev, self._pos_dev = tokens, positions
        return torch.stack(out)

    @torch.inference_mode()
    def _copy_page(self, dst: int, src: int) -> None:
        """Snapshot one pool page (copy-on-write boundary for
        store_prefix): the slot keeps writing into its private boundary
        page, so the stored prefix gets its own copy."""
        self.cache.k[:, dst] = self.cache.k[:, src]
        self.cache.v[:, dst] = self.cache.v[:, src]

    # ------------------------------------------------------------------
    # prefix store
    # ------------------------------------------------------------------

    def _incref(self, pid: int) -> None:
        self._page_refs[pid] += 1

    def _decref(self, pid: int) -> None:
        self._page_refs[pid] -= 1
        if self._page_refs[pid] == 0:
            self._free_pages.append(int(pid))

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Pop n free pages (refcount 1), LRU-evicting stored prefixes as
        needed. Pages shared with live slots survive eviction."""
        while len(self._free_pages) < n and len(self._prefix_lru) > 0:
            self._drop_key(self._prefix_lru[0])
        if len(self._free_pages) < n:
            return None
        out = [self._free_pages.pop() for _ in range(n)]
        for pid in out:
            self._page_refs[pid] = 1
        return out

    def _drop_key(self, key) -> None:
        sp = self._prefix_store.pop(key, None)
        if key in self._prefix_lru:
            self._prefix_lru.remove(key)
        if sp is None:
            return
        sp.dropped = True   # external handles must not restore from it
        ikey = (sp.namespace, sp.length, hash(sp.token_ids))
        if self._prefix_index.get(ikey) == key:
            del self._prefix_index[ikey]
        lens = self._ns_lengths.get(sp.namespace)
        if lens is not None:
            lens[sp.length] -= 1
            if lens[sp.length] == 0:
                del lens[sp.length]
            if not lens:
                del self._ns_lengths[sp.namespace]
        for pid in sp.pages:
            self._decref(pid)

    @property
    def prefix_pages_used(self) -> int:
        """Distinct pages held by the store (shared pages count once)."""
        used = set()
        for sp in self._prefix_store.values():
            used.update(int(p) for p in sp.pages)
        return len(used)

    @property
    def num_free_pages(self) -> int:
        return len(self._free_pages)

    def store_prefix(self, key, rollout: Rollout,
                     length: Optional[int] = None,
                     namespace: object = None) -> Optional[StoredPrefix]:
        """Save rollout's first ``length`` tokens of KV under ``key``: pin
        the slot's pages covering the prefix and snapshot at most one
        non-aligned boundary page. Returns None when the pool cannot hold
        the boundary copy."""
        length = rollout.length if length is None else length
        if key in self._prefix_store:
            return self._prefix_store[key]
        ids = tuple(rollout.token_ids[:length])
        slot = rollout.slot
        assert self._table_live[slot], "rollout's slot has no live table"
        table = self._tables[slot]
        k_full = length // self.page
        pages = [int(p) for p in table[:k_full]]
        for pid in pages:       # pin before any allocation can evict
            self._incref(pid)
        if length % self.page:
            boundary = int(table[k_full])
            if k_full < self._shared_n[slot]:
                # a SHARED ancestor page is immutable: reference it directly
                self._incref(boundary)
                pages.append(boundary)
            else:
                new = self._alloc_pages(1)
                if new is None:
                    for pid in pages:
                        self._decref(pid)
                    return None
                self._copy_page(new[0], boundary)
                self.counters["prefix_copy_rows"] += length % self.page
                pages.append(new[0])
        self.counters["prefix_saves"] += 1
        sp = StoredPrefix(pages=tuple(pages), length=length,
                          token_ids=ids, namespace=namespace)
        self._prefix_store[key] = sp
        self._prefix_lru.append(key)
        self._prefix_index[(namespace, length, hash(ids))] = key
        self._ns_lengths.setdefault(namespace, {})
        self._ns_lengths[namespace][length] = \
            self._ns_lengths[namespace].get(length, 0) + 1
        return sp

    def get_prefix(self, key) -> Optional[StoredPrefix]:
        sp = self._prefix_store.get(key)
        if sp is not None and key in self._prefix_lru:
            self._prefix_lru.remove(key)
            self._prefix_lru.append(key)
        return sp

    def best_prefix(self, token_ids: Sequence[int], namespace: object = None
                    ) -> Optional[Tuple[object, StoredPrefix]]:
        """Longest stored prefix in ``namespace`` matching ``token_ids``; a
        hit refreshes its LRU position. Indexed by (namespace, length,
        hash): deepest stored length first, one hash probe each."""
        best = None
        ids = tuple(token_ids)
        lens = self._ns_lengths.get(namespace)
        if lens:
            for length in sorted(lens, reverse=True):
                if length > len(ids):
                    continue
                head = ids[:length]
                key = self._prefix_index.get((namespace, length, hash(head)))
                if key is not None:
                    sp = self._prefix_store[key]
                    if sp.token_ids == head:
                        best = (key, sp)
                        break
        if best is not None and best[0] in self._prefix_lru:
            self._prefix_lru.remove(best[0])
            self._prefix_lru.append(best[0])
        return best

    def has_prefix(self, key) -> bool:
        return key in self._prefix_store

    def drop_prefix(self, key) -> None:
        """Evict one stored prefix (frees its unshared pages)."""
        self._drop_key(key)

    def drop_namespace(self, namespace: object) -> None:
        """Evict all prefixes belonging to one generator/image."""
        for key in [k for k, sp in self._prefix_store.items()
                    if sp.namespace == namespace]:
            self._drop_key(key)

    # ------------------------------------------------------------------
    # rollout lifecycle
    # ------------------------------------------------------------------

    def _launch_group(self, rollouts: List[Rollout],
                      prefixes: List[Optional[StoredPrefix]],
                      image_embeds: Optional[torch.Tensor]) -> None:
        """Run ONE fused start for these rollouts. Each row may carry its
        own stored prefix (or none); first tokens arrive lazily."""
        b = len(rollouts)
        page, m_cap = self.page, self._m_cap
        starts_l: List[int] = []
        tails: List[List[int]] = []
        for ro, pf in zip(rollouts, prefixes):
            start_pos = 0
            if pf is not None:
                start_pos = min(pf.length, len(ro.token_ids) - 1)
                self.counters["prefix_starts"] += 1
            starts_l.append(start_pos)
            tails.append(ro.token_ids[start_pos:])
        bucket = _bucket(max(len(t) for t in tails), self.max_len)
        for i, ro in enumerate(rollouts):
            # keep every written row inside [0, max_len): rows beyond would
            # divert to the trash page and lose real content. Re-prefill a
            # bit more of the (matching) prefix instead.
            if starts_l[i] + bucket > self.max_len:
                starts_l[i] = self.max_len - bucket
                tails[i] = ro.token_ids[starts_l[i]:]

        # --- page tables: shared stored pages for the restored prefix,
        # fresh private pages for everything else. Pin EVERY page the wave
        # READS (full pages that join the slot table AND the non-aligned
        # boundary page the COW gather copies from) before any allocation:
        # allocating may LRU-evict a stored prefix a row of this very wave
        # is restoring from.
        shared_rows: List[List[int]] = []
        boundary_pins: List[int] = []
        for i, (ro, pf) in enumerate(zip(rollouts, prefixes)):
            k_full = starts_l[i] // page
            shared = ([int(p) for p in pf.pages[:k_full]]
                      if pf is not None else [])
            for pid in shared:
                self._incref(pid)
            if pf is not None:
                n_read = -(-starts_l[i] // page)
                for pid in pf.pages[k_full:n_read]:
                    self._incref(int(pid))
                    boundary_pins.append(int(pid))
            shared_rows.append(shared)

        read_need = max((-(-s // page) for s in starts_l), default=0)
        pb = 0
        while pb < read_need:        # power-of-two page-count buckets
            pb = max(1, pb * 2)
        pb = min(pb, m_cap)
        read_tab = np.full((b, pb), self._trash_page, np.int32)
        write_tab = np.zeros((b, m_cap), np.int32)
        cow = np.zeros((b,), np.int32)
        installed: List[int] = []     # rows whose tables are already live
        for i, (ro, pf) in enumerate(zip(rollouts, prefixes)):
            slot, shared = ro.slot, shared_rows[i]
            assert not self._table_live[slot], "slot table leak"
            priv = self._alloc_pages(m_cap - len(shared))
            if priv is None:
                # roll back EVERYTHING this call did: wave pins, and the
                # tables already installed for earlier rows
                for j in installed:
                    s = rollouts[j].slot
                    for pid in self._tables[s]:
                        self._decref(int(pid))
                    self._table_live[s] = False
                for j, row in enumerate(shared_rows):
                    if j in installed:
                        continue      # already dropped via the table above
                    for pid in row:
                        self._decref(pid)
                for pid in boundary_pins:
                    self._decref(pid)
                raise RuntimeError("page pool exhausted")
            installed.append(i)
            table = shared + priv
            self._tables[slot] = table
            self._table_live[slot] = True
            self._shared_n[slot] = len(shared)
            write_tab[i] = table
            cow[i] = len(shared) * page
            self.counters["restore_cow_rows"] += starts_l[i] - int(cow[i])
            if pf is not None:
                n_read = -(-starts_l[i] // page)
                for j in range(pb):
                    read_tab[i, j] = (pf.pages[j] if j < n_read
                                      else table[j])
            else:
                read_tab[i, :] = table[:pb]

        # image tokens already in the restored cache before each block: a
        # re-prefilled image token must receive its TRUE position's embedding
        image_tok = self.cfg.image_token_id
        img_offsets = [ro.token_ids[:s].count(image_tok)
                       for ro, s in zip(rollouts, starts_l)]
        ids = np.zeros((b, bucket), np.int32)
        for i, t in enumerate(tails):
            ids[i, :len(t)] = t
        if image_embeds is None:
            image_embeds = torch.zeros(
                (1, self.cfg.image_seq_len, self.cfg.text.hidden_size),
                dtype=self.params.dtype, device=self.device)
        if image_embeds.shape[0] == 1 and b > 1:
            image_embeds = image_embeds.expand(b, *image_embeds.shape[1:])

        slots = [ro.slot for ro in rollouts]
        self.counters["starts"] += b
        self.counters["start_dispatches"] += 1
        self.counters["prefill_tokens"] += sum(len(t) for t in tails)
        self.counters["prefill_tokens_saved"] += sum(starts_l)
        put = self._put
        firsts = self._start_wave(
            put(slots), put(ids), image_embeds, put(starts_l),
            put([len(t) for t in tails]), put(img_offsets), put(read_tab),
            put(write_tab), put(cow),
            put(self._samp_host[slots], torch.float32))
        for i, ro in enumerate(rollouts):
            self._rollouts[ro.slot] = ro
            self._active[ro.slot] = True
            self._first_pending[ro.slot] = firsts[i]
        # boundary pages were only read by the wave just enqueued; anything
        # that recycles them writes in a LATER launch on the same stream
        for pid in boundary_pins:
            self._decref(pid)

    def _make_rollout(self, token_ids: Sequence[int], max_new_tokens: int,
                      sampling: Optional[SamplingParams],
                      on_token) -> Rollout:
        slot = self._free_slots.pop()
        sp = sampling if sampling is not None else self.sampling
        self._samp_host[slot] = (sp.temperature, sp.top_p, float(sp.top_k))
        return Rollout(slot=slot, prompt_len=len(token_ids),
                       token_ids=list(token_ids),
                       max_new_tokens=max(
                           min(max_new_tokens,
                               self._trash_start - len(token_ids)), 1),
                       on_token=on_token)

    @staticmethod
    def _check_prefix(token_ids: Sequence[int],
                      prefix: Optional[StoredPrefix]
                      ) -> Optional[StoredPrefix]:
        if prefix is None or prefix.dropped:
            return None     # evicted: its pages may have been recycled
        assert tuple(token_ids[:prefix.length]) == prefix.token_ids, \
            "prefix mismatch"
        return prefix

    def start(
        self,
        token_ids: Sequence[int],
        image_embeds: Optional[torch.Tensor] = None,
        *,
        max_new_tokens: int = 1024,
        on_token: Optional[Callable[[int], None]] = None,
        prefix: Optional[StoredPrefix] = None,
        lazy: bool = False,
        sampling: Optional[SamplingParams] = None,
    ) -> Rollout:
        """Begin generating after ``token_ids``; returns a Rollout handle.
        With ``lazy=True`` the first token is fetched at the next
        ``step()``/``flush()``."""
        if not self._free_slots:
            raise RuntimeError("no free slots")
        token_ids = list(token_ids)
        prefix = self._check_prefix(token_ids, prefix)
        ro = self._make_rollout(token_ids, max_new_tokens, sampling,
                                on_token)
        try:
            self._launch_group([ro], [prefix], image_embeds)
        except BaseException:
            self._free_slots.append(ro.slot)   # never launched: return it
            raise
        if not lazy:
            self.flush()
        return ro

    def start_many(
        self,
        prompts: Sequence[Sequence[int]],
        image_embeds: Optional[torch.Tensor] = None,  # [B,seq,H] or [1,..]
        *,
        max_new_tokens=1024,                          # int or per-prompt seq
        prefix: Optional[StoredPrefix] = None,        # shared by all
        prefixes: Optional[Sequence[Optional[StoredPrefix]]] = None,
        sampling: Optional[SamplingParams] = None,
        on_token: Optional[Callable[[int], None]] = None,
    ) -> List[Rollout]:
        """Start a BURST of rollouts, chunked into power-of-two groups (one
        fused start each). Starts are lazy."""
        b = len(prompts)
        assert b >= 1
        if b > len(self._free_slots):
            raise RuntimeError("no free slots")
        if prefixes is None:
            prefixes = [prefix] * b
        assert len(prefixes) == b
        pfs = [self._check_prefix(p, pf)
               for p, pf in zip(prompts, prefixes)]
        mnt = (list(max_new_tokens)
               if isinstance(max_new_tokens, (list, tuple))
               else [max_new_tokens] * b)
        assert len(mnt) == b
        rollouts = [self._make_rollout(list(p), m, sampling, on_token)
                    for p, m in zip(prompts, mnt)]
        if (image_embeds is not None and image_embeds.shape[0] == 1
                and b > 1):
            image_embeds = image_embeds.expand(b, *image_embeds.shape[1:])
        # pin every restored prefix's pages for the WHOLE burst: an early
        # chunk's allocation may LRU-evict a prefix a later chunk restores
        burst_pins = [int(p) for pf in pfs if pf is not None
                      for p in pf.pages]
        for pid in burst_pins:
            self._incref(pid)
        i = 0
        try:
            while i < b:
                n = 1
                while n * 2 <= b - i:  # largest power of two that fits
                    n *= 2
                emb = (None if image_embeds is None
                       else image_embeds[i:i + n])
                self._launch_group(rollouts[i:i + n], pfs[i:i + n], emb)
                i += n
        except BaseException:
            for ro in rollouts[i:]:    # never launched: return their slots
                self._free_slots.append(ro.slot)
            raise
        finally:
            for pid in burst_pins:
                self._decref(pid)
        return rollouts

    def _fetch_firsts(self) -> List[Tuple[int, int]]:
        slots = list(self._first_pending)
        if not slots:
            return []
        values = torch.stack([self._first_pending[s] for s in slots]).tolist()
        self._first_pending.clear()
        return list(zip(slots, values))

    def flush(self) -> List[Rollout]:
        """Fetch pending first tokens to the host; returns rollouts that
        finished as a result (eos/abort/budget)."""
        finished = []
        for slot, tok in self._fetch_firsts():
            ro = self._rollouts.get(slot)
            if ro is None:
                continue
            self._accept_token(ro, int(tok))
            if ro.finished:
                finished.append(ro)
        return finished

    def _banned(self) -> tuple:
        return (self.cfg.image_token_id,)

    def _suppress(self) -> tuple:
        return (self.eos_token_id,)

    def _accept_token(self, ro: Rollout, tok: int) -> None:
        ro.token_ids.append(tok)
        ro.new_tokens += 1
        if ro.on_token is not None:
            ro.on_token(tok)
        if tok == self.eos_token_id:
            ro.finished, ro.finish_reason = True, "eos"
        elif ro.new_tokens >= ro.max_new_tokens:
            ro.finished, ro.finish_reason = True, "length"
        elif ro.aborted:
            ro.finished, ro.finish_reason = True, "abort"
        if ro.finished:
            self._active[ro.slot] = False

    def abort(self, ro: Rollout) -> None:
        ro.aborted = True

    def release(self, ro: Rollout) -> None:
        if ro.slot in self._rollouts and self._rollouts[ro.slot] is ro:
            del self._rollouts[ro.slot]
            self._active[ro.slot] = False
            self._first_pending.pop(ro.slot, None)
            self._free_slots.append(ro.slot)
            if self._table_live[ro.slot]:
                # drop the slot's page references; pages pinned by stored
                # prefixes survive. Stale device-table entries are safe:
                # released slots only ever write through the trash page.
                for pid in self._tables[ro.slot]:
                    self._decref(int(pid))
                self._table_live[ro.slot] = False

    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    @property
    def num_free_slots(self) -> int:
        """Slots available for ``start``/``start_many`` right now."""
        return len(self._free_slots)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _kv_pages(self, k: int) -> int:
        """Attended-page bound for a k-step block: the smallest bucket
        covering every live slot's rows after k more steps, in pages."""
        live = [len(ro.token_ids) for slot, ro in self._rollouts.items()
                if self._active[slot]]
        limit = self.max_len
        if live:
            need = max(live) + k + 1
            for b in BUCKETS:
                if need <= b <= self.max_len:
                    limit = b
                    break
        return -(-limit // self.page)

    def step(self, k: Optional[int] = None) -> List[Rollout]:
        """Advance decoding by one block of k steps (default
        ``decode_block``); one host sync fetches the block's tokens and any
        pending first tokens. Returns rollouts that finished."""
        k = self.decode_block if k is None else k
        toks = None
        owners: Dict[int, Rollout] = {}
        if self._active.any():
            self.counters["decode_dispatches"] += 1
            self.counters["decode_steps"] += k
            kv_pages = self._kv_pages(k)
            toks_dev = self._decode_many(
                self._put(self._active, torch.bool),
                self._put(self._samp_host, torch.float32), k, kv_pages)
            owners = {slot: ro for slot, ro in self._rollouts.items()
                      if self._active[slot]}
        firsts = self._fetch_firsts()
        if owners:
            toks = toks_dev.cpu().numpy()            # [k, S]

        finished = []
        for slot, tok in firsts:
            ro = self._rollouts.get(slot)
            if ro is None:
                continue
            self._accept_token(ro, int(tok))
            if ro.finished:
                finished.append(ro)
        for slot, ro in owners.items():
            if self._rollouts.get(slot) is not ro or ro.finished:
                continue
            for i in range(k):
                self.counters["decode_tokens"] += 1
                self._accept_token(ro, int(toks[i, slot]))
                if ro.finished:
                    finished.append(ro)
                    break
        return finished

    def run(self, max_steps: Optional[int] = None) -> List[Rollout]:
        """Step until every rollout finishes; returns them all."""
        done: List[Rollout] = []
        steps = 0
        while self._active.any() or self._first_pending:
            done.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return done

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_image(self, pixel_values) -> torch.Tensor:
        """[B,H,W,C] (numpy or tensor) -> projected image tokens (vision
        runs once per image)."""
        pv = torch.as_tensor(np.asarray(pixel_values)
                             if not torch.is_tensor(pixel_values)
                             else pixel_values, device=self.device)
        return detikzify.encode_image(self.params, self.cfg, pv)
