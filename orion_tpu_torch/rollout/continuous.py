"""Continuous-batching generation engine (port of
``orion_tpu/rollout/continuous.py``, the serving slice).

A fixed number of engine SLOTS decode in lockstep, segment by segment,
while the native page scheduler (``orion_tpu_torch.runtime``) admits
waiting requests into freed slots BETWEEN segments.  Device state is
one persistent paged-KV pool per layer plus a block table per slot;
each slot's pages come from the scheduler, so a retiring sequence's
pages recycle into the next admission with no reshuffling.

Request service: ``submit()`` enqueues, each ``step()`` runs one wave —
admit -> prefill the admitted prompts and sample their first token ->
grow in-flight reservations (preempting the youngest decoding request
when the pool runs dry; restart-by-recompute) -> one decode segment of
``segment_len`` tokens for every slot -> harvest finished slots and
free their pages.  ``generate()`` is the run-to-completion wrapper.

Differences from the JAX engine, none of which changes a completion:
the programs run eagerly (a CUDA graph of the segment is later work);
pools and per-slot state update in place; finished slots are harvested
in the wave that finishes them (the JAX engine's ``harvest_lag=0``,
its setting off-TPU); sampling draws from a ``torch.Generator``.  The
optional machinery of the JAX engine — prefix cache, chunked prefill,
speculative decoding, k-clone groups, int8 pools and weights, host
tier, repetition penalty, tenants, streaming, meshes — is not ported
yet.  ``generate_batch`` is the trainer-facing surface: a padded
``GenerationResult`` for a batch of prompts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from orion_tpu_torch.config import ModelConfig, RolloutConfig
from orion_tpu_torch.device import resolve_device
from orion_tpu_torch.ops.logprobs import pack_sequences
from orion_tpu_torch.ops.sampling import (eos_forbid_mask, is_stop_token,
                                          sample_tokens)
from orion_tpu_torch.rollout.engine import GenerationResult
from orion_tpu_torch.runtime import Scheduler

# slot lifecycle: empty -> decoding (admitted, prompt prefilled, first
# token sampled, all in one wave) -> empty (harvested or preempted).
_EMPTY, _DECODE = 0, 1


@dataclasses.dataclass
class CompletedRequest:
    req_id: int
    tokens: np.ndarray          # [n] completion token ids
    logprobs: np.ndarray        # [n] sampling-dist logprobs (f32)
    policy_logprobs: np.ndarray  # [n] raw (untempered) policy logprobs


def _masked_set(buf: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                live: torch.Tensor) -> None:
    """buf[s, col[s]] = val[s] where live[s], in place.  Dead rows (whose
    column may be out of range — the JAX engine's dropped write) write
    their own current value back at a clamped column."""
    idx = col.clamp(max=buf.shape[1] - 1).to(torch.int64)[:, None]
    cur = torch.gather(buf, 1, idx)[:, 0]
    buf.scatter_(1, idx, torch.where(live, val.to(buf.dtype), cur)[:, None])


class ContinuousBatchingEngine:
    """Throughput-oriented generation over a stream of requests.

    ``model`` is the port's :class:`~orion_tpu_torch.models.Transformer`
    (its weights are the engine's).  ``device=None`` means the card and
    raises without one; the model is moved to the engine's device."""

    # k-clone group admission (one prefill and shared prompt pages per
    # group) is not ported yet: a group trainer hands over the batch
    # already repeated in the i*k+j layout, which gives the same rows.
    supports_groups = False

    def __init__(self, model, model_cfg: ModelConfig, cfg: RolloutConfig,
                 eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                 segment_len: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.mc = model_cfg
        self.cfg = cfg
        cfg.check_stop_ids(model_cfg.vocab_size, eos_token_id)
        self.eos = eos_token_id
        self.pad = pad_token_id
        self.segment_len = (cfg.segment_len if segment_len is None
                            else segment_len)
        self.slots = cfg.max_batch_size
        ps = cfg.page_size
        self.pages_per_seq = -(-(cfg.max_prompt_len + cfg.max_new_tokens)
                               // ps)
        self.num_pages = cfg.num_pages or self.slots * self.pages_per_seq
        wm = (cfg.page_watermark if cfg.page_watermark >= 0
              else self.slots)
        self.sched = Scheduler(self.num_pages, ps, self.slots,
                               watermark=wm, policy=cfg.admission_policy)
        # One extra scratch page (index num_pages): inactive slots point
        # their whole block table at it, so their masked lockstep writes
        # never touch a live request's pages.  Zero-initialised: masked
        # slots still enter the PV product with p = 0.
        self._scratch = self.num_pages
        shape = (self.num_pages + 1, model_cfg.num_kv_heads, ps,
                 model_cfg.head_dim)
        dt = self.model.embed.weight.dtype
        self._pools = [
            {"k_pages": torch.zeros(shape, dtype=dt, device=self.device),
             "v_pages": torch.zeros(shape, dtype=dt, device=self.device)}
            for _ in range(model_cfg.num_layers)]
        self._bt = np.full((self.slots, self.pages_per_seq), self._scratch,
                           np.int32)
        self._bt_dev = None     # device copy of _bt, rebuilt when dirty
        self._state = None
        self._slot_req = np.full(self.slots, -1, np.int64)
        self._phase = np.zeros(self.slots, np.int8)
        self._est_len = np.zeros(self.slots, np.int64)  # host len bound
        self._reqinfo: dict = {}     # req id -> (ids, budget)
        self._admit_seq: dict = {}   # req id -> admission counter
        self._admit_counter = 0
        self._gen: Optional[torch.Generator] = None
        self.preemptions = 0         # recompute-restarts
        # Model forwards since construction: one per prefill wave and one
        # per lockstep decode step (each runs every layer once).
        self.prefill_forwards = 0
        self.decode_steps = 0
        # Time to first token per request id: submit to the end of the
        # wave that sampled the first token (a wave ends in a device
        # sync, so this is device-complete time).  The caller reads and
        # clears ``ttft``; ``_submit_time`` holds requests still waiting
        # for their first token.
        self._submit_time: dict = {}
        self.ttft: dict = {}

    def _init_state(self) -> dict:
        """Per-slot device state: decode cursor + completion buffers."""
        S, T = self.slots, self.cfg.max_new_tokens
        kw = {"device": self.device}
        return {
            "cur_tok": torch.zeros(S, dtype=torch.int32, **kw),
            "lengths": torch.zeros(S, dtype=torch.int32, **kw),
            "done": torch.ones(S, dtype=torch.bool, **kw),  # empty = done
            "n_new": torch.zeros(S, dtype=torch.int32, **kw),
            "budget": torch.full((S,), T, dtype=torch.int32, **kw),
            "toks": torch.full((S, T), self.pad, dtype=torch.int32, **kw),
            "lps": torch.zeros((S, T), dtype=torch.float32, **kw),
            "plps": torch.zeros((S, T), dtype=torch.float32, **kw),
        }

    # -- weights and sampling stream ------------------------------------
    @torch.no_grad()
    def load_weights(self, state_dict) -> None:
        """Install new weights (a state dict of the engine's model),
        cast to the model's dtype."""
        self.model.load_state_dict(state_dict)

    def reset_rng(self, seed: int) -> None:
        """Seed (or reseed) the service sampling stream."""
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

    # -- request surface --------------------------------------------------
    def submit(self, req_id: int, ids, budget: Optional[int] = None,
               priority: int = 0, deadline: Optional[int] = None) -> None:
        """Enqueue a request.  ``budget`` <= cfg.max_new_tokens caps the
        completion; priority/deadline feed cfg.admission_policy."""
        cfg = self.cfg
        ids = np.asarray(ids, np.int32)
        budget = int(cfg.max_new_tokens if budget is None else budget)
        if len(ids) < 1 or len(ids) > cfg.max_prompt_len:
            raise ValueError(
                f"prompt {req_id}: length {len(ids)} outside "
                f"[1, max_prompt_len={cfg.max_prompt_len}]")
        if not 1 <= budget <= cfg.max_new_tokens:
            raise ValueError(
                f"request {req_id}: budget {budget} outside "
                f"[1, max_new_tokens={cfg.max_new_tokens}]")
        if req_id in self._reqinfo:
            raise ValueError(f"request id {req_id} already in flight")
        self.sched.add(req_id, len(ids), budget, priority=priority,
                       deadline=-1 if deadline is None else int(deadline))
        self._reqinfo[req_id] = (ids, budget)
        self._submit_time[req_id] = time.perf_counter()

    @property
    def pending(self) -> int:
        """Requests submitted but not yet returned by ``step``."""
        return len(self._reqinfo)

    def step(self) -> List[CompletedRequest]:
        """Run ONE wave of the service; returns the requests that
        completed in it."""
        if self._gen is None:
            raise ValueError("no sampling stream: call reset_rng() first")
        if self._state is None:
            self._state = self._init_state()
        with torch.no_grad():
            return self._step_wave()

    def generate(self, requests: Iterable[tuple], seed: int = 0
                 ) -> List[CompletedRequest]:
        """Run all requests to completion; returns them in finish order.

        requests: iterable of (req_id, prompt_ids) or (req_id,
        prompt_ids, budget).  Every request is validated before the
        first is submitted, so a bad one leaves the engine untouched."""
        self.reset_rng(seed)
        reqs = []
        seen = set(self._reqinfo)
        for r in requests:
            req_id, ids = r[0], np.asarray(r[1], np.int32)
            budget = (int(r[2]) if len(r) > 2 and r[2] is not None
                      else self.cfg.max_new_tokens)
            if req_id in seen:
                raise ValueError(f"request id {req_id} already in flight")
            seen.add(req_id)
            if len(ids) > self.cfg.max_prompt_len:
                raise ValueError(f"prompt {req_id} longer than "
                                 f"max_prompt_len={self.cfg.max_prompt_len}")
            if not 1 <= budget <= self.cfg.max_new_tokens:
                raise ValueError(
                    f"request {req_id}: budget {budget} outside "
                    f"[1, max_new_tokens={self.cfg.max_new_tokens}]")
            reqs.append((req_id, ids, budget))
        for req_id, ids, budget in reqs:
            self.submit(req_id, ids, budget=budget)
        out: List[CompletedRequest] = []
        while self.sched.waiting or self.sched.running:
            out.extend(self.step())
        return out

    def generate_batch(self, prompt_ids, prompt_lens, seed: int
                       ) -> GenerationResult:
        """Run a batch of prompts as a request stream and pack the
        completions into a padded :class:`GenerationResult` (the JAX
        engine's ``generate_batch`` without group admission).

        prompt_ids [B, P] right-padded, prompt_lens [B]; row i of the
        result is prompt i's completion, sampled from the stream seeded
        with ``seed``; completions are padded to cfg.max_new_tokens."""
        T = self.cfg.max_new_tokens
        prompt_ids = np.asarray(prompt_ids, np.int32)
        prompt_lens = np.asarray(prompt_lens, np.int32)
        B = prompt_ids.shape[0]
        by_id = {r.req_id: r for r in self.generate(
            [(i, prompt_ids[i, :prompt_lens[i]]) for i in range(B)],
            seed=seed)}
        tokens = np.full((B, T), self.pad, np.int32)
        logps = np.zeros((B, T), np.float32)
        plogps = np.zeros((B, T), np.float32)
        comp_len = np.zeros((B,), np.int32)
        for i in range(B):
            r = by_id[i]
            n = len(r.tokens)
            tokens[i, :n] = r.tokens
            logps[i, :n] = r.logprobs
            plogps[i, :n] = r.policy_logprobs
            comp_len[i] = n
        mask = (np.arange(T)[None, :] < comp_len[:, None]).astype(np.float32)
        sequences = pack_sequences(torch.from_numpy(prompt_ids),
                                   torch.from_numpy(prompt_lens),
                                   torch.from_numpy(tokens)).numpy()
        return GenerationResult(
            sequences=sequences, completions=tokens,
            completion_mask=mask, completion_lens=comp_len,
            logprobs=logps, policy_logprobs=plogps,
            prompt_lens=prompt_lens, total_lens=prompt_lens + comp_len)

    # -- one wave ---------------------------------------------------------
    def _step_wave(self) -> List[CompletedRequest]:
        admitted = self.sched.admit()
        if (not admitted and not self.sched.running
                and self.sched.waiting):
            raise RuntimeError(
                f"{self.sched.waiting} request(s) can never be "
                f"scheduled: pool of {self.num_pages} pages is too "
                "small for a single request's admission")
        for rid, slot in admitted:
            self._slot_req[slot] = rid
            self._admit_seq[rid] = self._admit_counter
            self._admit_counter += 1
        if admitted:
            self._activate(admitted)
        self._extend_running()
        out: List[CompletedRequest] = []
        if (self._phase == _DECODE).any():
            if self._bt_dev is None:
                self._bt_dev = torch.from_numpy(self._bt).to(self.device)
            self._segment(self.segment_len)
            out = self._harvest()
        now = time.perf_counter()
        for rid, _slot in admitted:
            # A preempted request keeps the TTFT of its first admission.
            t0 = self._submit_time.pop(rid, None)
            if t0 is not None:
                self.ttft[rid] = now - t0
        return out

    def _activate(self, admitted) -> None:
        """Prefill the admitted prompts through their block tables,
        sample each request's first token and seed its slot state."""
        cfg = self.cfg
        pps = self.pages_per_seq
        n = len(admitted)
        Pw = max(len(self._reqinfo[rid][0]) for rid, _ in admitted)
        # ONE host->device upload: [prompt_len, slot, budget,
        # block-table row (pps), prompt ids right-padded (Pw)].
        packed = np.full((n, 3 + pps + Pw), self.pad, np.int32)
        for b, (rid, slot) in enumerate(admitted):
            ids, budget = self._reqinfo[rid]
            pages = self.sched.pages(rid)
            self._bt[slot, :len(pages)] = pages
            # Unreserved tail -> scratch: prefill writes KV for every
            # padded position, which must not land on a live page.
            self._bt[slot, len(pages):] = self._scratch
            self._phase[slot] = _DECODE
            self._est_len[slot] = len(ids)
            packed[b, :3] = (len(ids), slot, budget)
            packed[b, 3:3 + pps] = self._bt[slot]
            packed[b, 3 + pps:3 + pps + len(ids)] = ids
        self._bt_dev = None
        dev = torch.from_numpy(packed).to(self.device)
        plen = dev[:, 0]
        slots = dev[:, 1].to(torch.int64)
        budgets = dev[:, 2]
        bt_rows = dev[:, 3:3 + pps]
        prompt = dev[:, 3 + pps:]
        positions = torch.arange(Pw, dtype=torch.int32,
                                 device=self.device)[None, :].expand(n, Pw)
        cache = [{**p, "block_tables": bt_rows} for p in self._pools]
        # Vocab projection only at the last real prompt token.
        logits = self.model(prompt, positions, cache,
                            logits_positions=(plen - 1)[:, None])[:, 0]
        self.prefill_forwards += 1
        kw = {}
        if cfg.effective_min_new(self.eos) > 0:
            # Nothing generated yet: every terminator is suppressed.
            kw["forbid"] = eos_forbid_mask(n, logits.shape[-1], self.eos,
                                           True, cfg.stop_token_ids,
                                           device=self.device)
        tok0, lp0, plp0 = sample_tokens(
            self._gen, logits, temperature=cfg.temperature,
            top_k=cfg.top_k, top_p=cfg.top_p, **kw)
        d0 = is_stop_token(tok0, self.eos, cfg.stop_token_ids)
        st = self._state
        st["cur_tok"][slots] = tok0
        st["lengths"][slots] = plen
        st["budget"][slots] = budgets
        st["done"][slots] = d0 | (budgets <= 1)
        st["n_new"][slots] = 1
        st["toks"][slots, 0] = tok0
        st["lps"][slots, 0] = lp0
        st["plps"][slots, 0] = plp0

    def _segment(self, n_steps: int) -> None:
        """Decode n_steps tokens for all slots in lockstep into the
        per-slot device buffers.  Done slots idle in place: their
        writes are masked and their cache position stays put, so a
        finished request never overruns its page reservation."""
        cfg = self.cfg
        st = self._state
        cache = [{**p, "block_tables": self._bt_dev} for p in self._pools]
        min_new = cfg.effective_min_new(self.eos)
        for _ in range(n_steps):
            # cur_tok was sampled for position `lengths`: write it there
            # and predict the next token.
            logits = self.model(st["cur_tok"][:, None],
                                st["lengths"][:, None], cache)[:, 0]
            self.decode_steps += 1
            kw = {}
            if min_new > 0:
                kw["forbid"] = eos_forbid_mask(
                    self.slots, logits.shape[-1], self.eos,
                    st["n_new"] < min_new, cfg.stop_token_ids,
                    device=self.device)
            nxt, lp, plp = sample_tokens(
                self._gen, logits, temperature=cfg.temperature,
                top_k=cfg.top_k, top_p=cfg.top_p, **kw)
            live = ~st["done"]
            nxt = torch.where(live, nxt, torch.full_like(nxt, self.pad))
            _masked_set(st["toks"], st["n_new"], nxt, live)
            _masked_set(st["lps"], st["n_new"], lp, live)
            _masked_set(st["plps"], st["n_new"], plp, live)
            st["n_new"] += live.to(torch.int32)
            st["lengths"] += live.to(torch.int32)
            st["cur_tok"] = torch.where(live, nxt, st["cur_tok"])
            st["done"] = (st["done"] | (st["n_new"] >= st["budget"])
                          | (live & is_stop_token(nxt, self.eos,
                                                  cfg.stop_token_ids)))

    def _harvest(self) -> List[CompletedRequest]:
        """Retire every decoding slot whose request is done: fetch its
        completion, free its pages, empty the slot."""
        st = self._state
        flags = torch.stack([st["done"].to(torch.int32), st["n_new"]]).cpu()
        done_h, n_new_h = flags[0].numpy(), flags[1].numpy()
        finished = [s for s in range(self.slots)
                    if self._phase[s] == _DECODE and done_h[s]]
        out: List[CompletedRequest] = []
        if not finished:
            return out
        rows = {k: st[k].cpu().numpy() for k in ("toks", "lps", "plps")}
        for s in finished:
            rid = int(self._slot_req[s])
            n = int(n_new_h[s])
            out.append(CompletedRequest(
                req_id=rid,
                tokens=rows["toks"][s][:n].astype(np.int32),
                logprobs=rows["lps"][s][:n].astype(np.float32),
                policy_logprobs=rows["plps"][s][:n].astype(np.float32)))
            self.sched.finish(rid)
            del self._reqinfo[rid]
            self._admit_seq.pop(rid, None)
            self._slot_req[s] = -1
            self._phase[s] = _EMPTY
            self._bt[s, :] = self._scratch
            self._bt_dev = None
        return out

    # -- on-demand pages and preemption -----------------------------------
    def _extend_running(self) -> None:
        """Grow every decoding slot's reservation to cover the next
        segment, preempting youngest-first when the pool runs dry."""
        for slot in range(self.slots):
            if self._phase[slot] != _DECODE:
                continue
            rid = int(self._slot_req[slot])
            ids, budget = self._reqinfo[rid]
            target = min(len(ids) + budget,
                         int(self._est_len[slot]) + self.segment_len)
            while True:
                got = self.sched.extend(rid, target)
                if got >= 0:
                    break
                victims = [r for r in self._admit_seq
                           if r != rid
                           and self._phase[self.sched.slot(r)] == _DECODE]
                if not victims:
                    raise RuntimeError(
                        f"page pool exhausted: {self.num_pages} pages "
                        f"cannot cover request {rid} even after "
                        "preempting all others — raise num_pages or "
                        "lower max_batch_size")
                self._preempt_req(
                    max(victims, key=lambda r: self._admit_seq[r]))
            if got > 0:
                pages = self.sched.pages(rid)
                self._bt[slot, :len(pages)] = pages
                self._bt_dev = None
            self._est_len[slot] = target

    def _preempt_req(self, rid: int) -> None:
        """Recompute-preemption: return the victim's pages and slot and
        requeue it (the scheduler keeps its arrival position); its
        partial completion is discarded and it restarts from the
        prompt.  The zombie slot keeps decoding into the scratch page
        until a later admission re-seeds it — masked work."""
        slot = self.sched.slot(rid)
        self.sched.preempt(rid)
        self._slot_req[slot] = -1
        self._phase[slot] = _EMPTY
        self._admit_seq.pop(rid, None)
        self._bt[slot, :] = self._scratch
        self._bt_dev = None
        self.preemptions += 1
