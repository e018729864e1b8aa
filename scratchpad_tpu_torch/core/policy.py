"""Waiting-queue priority policies and prefill admission budgeting.

Re-implements SchedulePolicy and PrefillAdder semantics
(reference: scratchpad/scheduler/policy_scheduler.py:25-341) over the
page-granular radix cache: admission reserves page budget for each request's
prefill plus an estimated decode headroom scaled by ``new_token_ratio``.
"""

from __future__ import annotations

import enum
import random
from typing import Optional

from scratchpad_tpu_torch.core.req import Req


class SchedulePolicy:
    """Orders the waiting queue (reference: policy_scheduler.py:34-75)."""

    def __init__(self, policy: str, tree_cache):
        self.policy = policy
        self.tree_cache = tree_cache

    def _tree(self, r: Req):
        tc = self.tree_cache
        return tc.for_req(r) if hasattr(tc, "for_req") else tc

    def calc_priority(self, waiting_queue: list[Req]) -> None:
        policy = self.policy
        if policy == "lpm":
            for r in waiting_queue:
                m = self._tree(r).match_prefix(r.origin_input_ids)
                r.cached_prefix_len = m.num_pages * self.tree_cache.page_size
                # note: match result nodes are re-resolved at admission time
            waiting_queue.sort(key=lambda r: -r.cached_prefix_len)
        elif policy == "fcfs":
            pass
        elif policy == "lof":  # longest output first
            waiting_queue.sort(key=lambda r: -r.sampling_params.max_new_tokens)
        elif policy == "random":
            random.shuffle(waiting_queue)
        elif policy == "dfs-weight":
            self._sort_by_dfs_weight(waiting_queue)
        else:
            raise ValueError(f"unknown schedule policy {policy!r}")

    def _sort_by_dfs_weight(self, waiting_queue: list[Req]) -> None:
        """Group requests sharing prefixes; visit heavy subtrees first
        (reference: policy_scheduler.py:58-95)."""
        node_reqs: dict[int, list[Req]] = {}
        node_of: dict[int, object] = {}
        for r in waiting_queue:
            m = self._tree(r).match_prefix(r.origin_input_ids)
            nid = id(m.last_node)
            node_reqs.setdefault(nid, []).append(r)
            node_of[nid] = m.last_node
        weights: dict[int, int] = {}

        def weight(node) -> int:
            nid = id(node)
            if nid not in weights:
                w = len(node_reqs.get(nid, []))
                for c in node.children.values():
                    w += weight(c)
                weights[nid] = w
            return weights[nid]

        tc = self.tree_cache
        roots = (
            [t.root for t in tc._trees.values()]
            if hasattr(tc, "_trees")
            else [tc.root]
        )
        for root in roots:
            weight(root)
        order: list[Req] = []

        def visit(node):
            order.extend(node_reqs.get(id(node), []))
            children = sorted(
                node.children.values(), key=lambda c: -weights.get(id(c), 0)
            )
            for c in children:
                visit(c)

        for root in roots:
            visit(root)
        seen = {id(r) for r in order}
        order.extend(r for r in waiting_queue if id(r) not in seen)
        waiting_queue[:] = order


class AddReqResult(enum.Enum):
    CONTINUE = enum.auto()
    NO_TOKEN = enum.auto()  # out of KV budget
    OTHER = enum.auto()  # hit batch/token caps


class PrefillAdder:
    """Token-budget admission for one prefill batch
    (reference: policy_scheduler.py:103-341)."""

    def __init__(
        self,
        tree_cache,
        page_allocator,
        running_reqs: list[Req],
        new_token_ratio: float,
        max_prefill_tokens: int,
        chunked_prefill_size: int,
        max_batch_reqs: int,
        sp_unchunked_limit: int = 0,
        sp_eligible=None,
    ):
        self.tree_cache = tree_cache
        self.page_size = page_allocator.page_size
        self.new_token_ratio = new_token_ratio
        self.rem_input_tokens = max_prefill_tokens
        self.chunked_prefill_size = chunked_prefill_size
        self.max_batch_reqs = max_batch_reqs
        # total-token budget: free pool + evictable tree pages, minus the
        # decode headroom the running batch is expected to need
        self.rem_total_tokens = (
            page_allocator.available_tokens
            + tree_cache.evictable_pages * self.page_size
        )
        for r in running_reqs:
            self.rem_total_tokens -= int(
                (r.sampling_params.max_new_tokens - len(r.output_ids))
                * new_token_ratio
            )
        self.can_run_list: list[Req] = []
        self.new_chunked_req: Optional[Req] = None
        self.new_chunked_len = 0
        self.log_input_tokens = 0
        # sequence-parallel prefill: a fresh prompt (no cached prefix) up to
        # this many tokens may run as ONE unchunked extend (the runner
        # routes it through ring attention over the mesh "sp" axis)
        self.sp_unchunked_limit = sp_unchunked_limit
        self.sp_eligible = sp_eligible

    def budget_state(self) -> AddReqResult:
        if self.rem_total_tokens <= 0:
            return AddReqResult.NO_TOKEN
        if self.rem_input_tokens <= 0 or len(self.can_run_list) >= self.max_batch_reqs:
            return AddReqResult.OTHER
        return AddReqResult.CONTINUE

    def add_one_req(self, req: Req) -> AddReqResult:
        """Try to admit; may truncate into a chunked prefill.

        Locks the matched radix path immediately so evictions triggered while
        admitting later requests cannot free it (reference: policy_scheduler.py
        locks tree nodes during admission)."""
        tree = (
            self.tree_cache.for_req(req)
            if hasattr(self.tree_cache, "for_req")
            else self.tree_cache
        )
        match = tree.match_prefix(req.origin_input_ids)
        num_pages = match.num_pages
        if num_pages * self.page_size >= len(req.origin_input_ids):
            # whole prompt cached: drop one page so at least one token is
            # computed and logits exist (reference: policy_scheduler.py:289)
            num_pages = max(num_pages - 1, 0)
        prefix_tokens = num_pages * self.page_size
        input_len = len(req.origin_input_ids) - prefix_tokens
        decode_budget = int(
            req.sampling_params.max_new_tokens * self.new_token_ratio
        )

        chunk_limit = self.chunked_prefill_size
        if (
            self.sp_unchunked_limit
            and prefix_tokens == 0
            and input_len <= self.sp_unchunked_limit
            and (self.sp_eligible is None or self.sp_eligible(req))
        ):
            chunk_limit = self.sp_unchunked_limit
        if input_len <= self.rem_input_tokens and input_len <= chunk_limit:
            # whole remaining prompt fits this batch
            if input_len + decode_budget > self.rem_total_tokens:
                return AddReqResult.NO_TOKEN
            self.rem_total_tokens -= input_len + decode_budget
            self.rem_input_tokens -= input_len
        else:
            # chunk it: take what fits, request stays in progress
            chunk = min(self.rem_input_tokens, self.chunked_prefill_size)
            chunk = (chunk // self.page_size) * self.page_size
            if chunk <= 0 or chunk > self.rem_total_tokens:
                return AddReqResult.NO_TOKEN if chunk > 0 else AddReqResult.OTHER
            self.rem_total_tokens -= chunk
            self.rem_input_tokens -= chunk
            self.new_chunked_req = req
            # the batch build must use THIS chunk length: it may be smaller
            # than chunked_prefill_size when rem_input_tokens ran low
            self.new_chunked_len = chunk
        req.cached_prefix_len = prefix_tokens
        req.last_node = match.last_node
        req.pages = match.page_ids[:num_pages].copy()
        req.num_tree_pages = num_pages
        tree.inc_lock_ref(match.last_node)
        self.can_run_list.append(req)
        self.log_input_tokens += min(input_len, self.chunked_prefill_size)
        return self.budget_state()
