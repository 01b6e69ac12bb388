"""Continuous-batching request queue: bounded admission, shape buckets,
worker-pull dispatch with batch-size bucket selection.

The serving engine (serving/engine.py) turns each stereo pair into a
``Request`` and offers it here.  Requests group by their padded-shape
bucket — RAFT-Stereo's fixed-iteration GRU loop makes per-frame device
time a function of the padded shape alone (PAPER.md §1), so same-bucket
requests batch with zero compute waste.  Admission control is a hard bound
on queued requests: past ``max_queue`` the submit raises the typed
``Overloaded`` (load shedding at the door beats collapsing under a
backlog), and during a drain new work is refused the same way while queued
work finishes.

Dispatch is **continuous batching**: there is no flush thread and no
``max_wait`` stall — a device worker that goes idle calls ``pop`` and
immediately takes whatever is queued.  ``pop`` picks the bucket whose head
request has waited longest and takes the largest configured batch size the
bucket's depth fills (``pick_batch_size``), so occupancy is set by queue
pressure, not by a timer: below capacity every request dispatches the
moment a worker is free (batch 1, minimum latency); once workers are busy
the queue deepens and the next pop grabs a 4 or an 8.  This replaced the
round-6 MicroBatcher, whose timed flush left the device idle while
requests aged toward ``max_wait_ms`` (BENCH_SERVE_r06.json: queue-wait p95
~4 s at offered 1.91 Hz with the device under-occupied).

Model-agnostic on purpose: the queue never touches the model or the
device, so every scheduling policy in this file is testable in
milliseconds.  The JAX package's ``serving/batcher.py``, copied whole (the
port imports nothing of that package); tests hold the two to the same
pops on the same request streams.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

from raft_stereo_tpu_torch.serving.metrics import ServingMetrics


class Overloaded(RuntimeError):
    """Typed load-shed rejection: the bounded queue is full, or the service
    is draining.  Callers should back off and retry (the HTTP layer maps
    this to 429/503 with Retry-After)."""

    def __init__(self, message: str, draining: bool = False):
        super().__init__(message)
        self.draining = draining


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before a device picked it up."""


class RequestPoisoned(RuntimeError):
    """Typed terminal failure of the supervised-recovery path: this
    request's dispatch crashed on every one of its bounded attempts, so
    it is failed individually instead of being retried forever or taking
    the server down.  ``last_error`` is the final dispatch's exception."""

    def __init__(self, message: str, attempts: int,
                 last_error: Optional[BaseException] = None):
        super().__init__(message)
        self.attempts = attempts
        self.last_error = last_error


@dataclasses.dataclass(eq=False)   # identity equality: payloads hold arrays
class Request:
    """One queued stereo pair.  ``payload`` is opaque to the queue (the
    engine stores images + padder there); ``bucket`` keys compatibility.
    ``tier`` extends the compatibility key: requests of different latency
    tiers run different compiled programs (per-tier early-exit knobs,
    serving/engine.py), so they never share a dispatch batch.
    ``trace``/``queue_span`` are likewise opaque (telemetry/spans.py
    handles of a sampled request — the engine opens/closes them; the
    queue only carries them across its threads)."""

    bucket: Tuple[int, int]
    payload: object
    future: Future
    t_enqueue: float
    deadline: Optional[float] = None  # absolute monotonic seconds
    tier: Optional[str] = None
    trace: Optional[object] = None
    queue_span: Optional[object] = None
    # Supervised-recovery bookkeeping (serving/engine.py): dispatch
    # attempts so far (a crashed dispatch requeues the request until the
    # engine's bound poisons it), and the tier the CLIENT asked for when
    # brownout degradation reroutes ``tier`` down the ladder
    # (``requested_tier is None`` means no degradation happened).
    attempts: int = 0
    requested_tier: Optional[str] = None
    # Executable family (serving/engine.py streaming sessions): None =
    # the base sessionless program; "state" = session cold frames (the
    # program additionally returns the low-res state); "warm" = session
    # warm frames (the program also CONSUMES a flow_init input).  Part
    # of the compatibility key below — the three families are distinct
    # compiled programs and must never share a dispatch batch.  Frames
    # of ONE session never coexist in the queue at all (the engine holds
    # the session's ordering lock from submit to resolution), so a
    # dispatch cycle cannot reorder a session's frames.
    family: Optional[str] = None
    session_id: Optional[str] = None
    # Model coordinate (serving/models.py registry): the registered
    # ``name`` this request's dispatch must consume the weights of.
    # None = the engine's implicit constructor model — the pre-registry
    # build, byte-identical.  Part of the compatibility key: two models
    # share shapes but never a dispatch batch (a batch is ONE forward
    # against ONE variables tree).
    model: Optional[str] = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    @property
    def group_key(self) -> Tuple:
        """What batches together: same padded bucket, same tier, same
        executable family (base / session-state / warm), same model."""
        return (self.bucket, self.tier, self.family, self.model)


def edf_key(req: Request) -> float:
    """The EDF scheduler's priority of one request: its absolute
    deadline, or — for deadline-less requests — its enqueue stamp.
    Both are monotonic-clock seconds, and an enqueue stamp is always in
    the past while a live deadline is in the future, so deadline-less
    requests sort AHEAD of every deadline-carrying one that arrived
    after their enqueue: a stream flood can never starve plain traffic
    (the no-starvation contract, tests/test_edf.py)."""
    return req.t_enqueue if req.deadline is None else req.deadline


def edf_slack_end(reqs: Sequence[Request], now: float,
                  max_slack_s: float, est_latency_s: float) -> float:
    """The absolute monotonic time an EDF pop may wait until before
    dispatching this group — the deliberate-coalescing window.

    Two hard bounds, both ANCHORED (absolute, so a re-evaluating waiter
    converges instead of sliding):

    * ``head_enqueue + max_slack_s`` — no request waits more than the
      configured slack beyond its arrival just to fatten a batch;
    * ``nearest_deadline - est_latency_s`` — the wait must leave the
      bucket's measured dispatch latency before the earliest deadline
      in the group, so coalescing can delay a frame but never be the
      REASON it misses (the bounded-slack contract).

    Groups with no deadline-carrying member return ``now`` — plain
    requests keep today's immediate-pop behavior."""
    deadlines = [r.deadline for r in reqs if r.deadline is not None]
    if not deadlines:
        return now
    head_enqueue = min(r.t_enqueue for r in reqs)
    return min(head_enqueue + max_slack_s,
               min(deadlines) - est_latency_s)


def pick_batch_size(depth: int, sizes: Sequence[int]) -> int:
    """The batch size a pop at queue depth ``depth`` dispatches: the
    largest compiled bucket size the depth fills.  A partial batch (depth
    between two sizes) dispatches at the next size down rather than being
    padded up — the batch axis carries no filler frames, ever; the
    remainder stays queued and the next free worker takes it immediately.
    ``sizes`` must be ascending and start at 1 (the engine validates)."""
    if depth < 1:
        raise ValueError(f"depth={depth} must be >= 1")
    fit = [s for s in sizes if s <= depth]
    if not fit:
        raise ValueError(f"no batch size in {tuple(sizes)} fits depth "
                         f"{depth}; sizes must include 1")
    return fit[-1]


def decompose_batch(n: int, sizes: Sequence[int]) -> List[int]:
    """Split ``n`` requests into dispatch chunks of configured sizes,
    largest-first (greedy): 7 -> [4, 2, 1] with the default 1/2/4/8 set.
    Used when deadline triage shrinks a popped batch below the size the
    scheduler picked — every device dispatch still runs a compiled
    batch-size bucket, never an ad-hoc batch axis."""
    out: List[int] = []
    while n > 0:
        k = pick_batch_size(n, sizes)
        out.append(k)
        n -= k
    return out


class BucketQueue:
    """Bucketed request queue for continuous batching.

    ``submit`` is the bounded front door (``Overloaded`` past ``max_queue``
    or while draining); ``pop`` is the worker side — it blocks until work
    is queued, then returns the oldest bucket's head requests at the batch
    size ``pick_batch_size`` selects.  Backpressure needs no extra
    machinery: a saturated worker pool simply stops popping, the queue
    fills, and submits shed at the bound.
    """

    def __init__(self, max_batch: int = 8,
                 batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 max_queue: int = 64,
                 metrics: Optional[ServingMetrics] = None,
                 clock=time.monotonic,
                 edf: bool = False,
                 edf_max_slack_s: float = 0.05,
                 latency_fn=None):
        """``edf=True`` turns on the round-19 deadline-aware pop policy:
        groups are taken earliest-deadline-first (``edf_key``) and a pop
        whose group cannot yet fill the largest compiled batch size
        WAITS a bounded slack (``edf_slack_end``: at most
        ``edf_max_slack_s`` past the head's arrival and never closer to
        the nearest deadline than the bucket's measured dispatch
        latency) to deliberately coalesce concurrent sessions' frames
        into one batch-N dispatch.  ``latency_fn(group_key, batch_size)
        -> seconds | None`` supplies that measured latency (the engine
        feeds a per-group EWMA of its dispatch wall); None/absent
        estimates 0.  Deadline-LESS requests keep today's immediate-pop
        FIFO behavior under either policy, and ``edf=False`` (default)
        leaves the existing pop path untouched."""
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        if edf_max_slack_s < 0:
            raise ValueError(f"edf_max_slack_s={edf_max_slack_s} must "
                             f"be >= 0")
        self.edf = bool(edf)
        self.edf_max_slack_s = float(edf_max_slack_s)
        self._latency_fn = latency_fn
        sizes = sorted(set(int(s) for s in batch_sizes if s <= max_batch))
        if not sizes or sizes[0] != 1 or any(s < 1 for s in sizes):
            raise ValueError(
                f"batch_sizes={tuple(batch_sizes)} must be positive and "
                f"include 1 after capping at max_batch={max_batch}")
        self.sizes = tuple(sizes)
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.metrics = metrics or ServingMetrics(max_batch=max_batch)
        self._clock = clock
        self._cond = threading.Condition()
        # (bucket, tier) -> FIFO of requests; the pop scan picks the group
        # whose head request has waited longest (global FIFO across
        # groups).
        self._buckets: Dict[Tuple, List[Request]] = {}
        self._depth = 0
        self._draining = False
        self._closed = False
        self._paused = False   # test hook: stage submits, then release

    # ------------------------------------------------------------ admission
    @property
    def depth(self) -> int:
        with self._cond:
            return self._depth

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    def submit(self, req: Request) -> None:
        with self._cond:
            if self._draining or self._closed:
                self.metrics.rejected_draining.inc()
                raise Overloaded("service is draining; not accepting work",
                                 draining=True)
            if self._depth >= self.max_queue:
                self.metrics.rejected_queue_full.inc()
                raise Overloaded(
                    f"queue full ({self._depth}/{self.max_queue} requests "
                    f"waiting); retry later")
            self._buckets.setdefault(req.group_key, []).append(req)
            self._depth += 1
            self.metrics.admitted.inc()
            self.metrics.queue_depth.set(self._depth)
            # notify_all, not notify: with worker CLASSES (solo vs xl
            # device groups, serving/engine.py) a single wake could land
            # on a worker whose ``want`` filter rejects this request's
            # group while an eligible worker sleeps on.
            self._cond.notify_all()

    def requeue(self, reqs: Sequence[Request]) -> int:
        """Re-admit requests whose dispatch crashed (supervised recovery,
        serving/engine.py).  Returns how many actually re-entered.

        Differs from ``submit`` deliberately:

        * **no admission bound** — these requests were already admitted
          once; shedding them now would turn a transient device fault
          into client-visible drops while fresh submits still succeed;
        * **allowed while draining** — a drain must finish admitted work,
          and that includes work bounced by a crash mid-drain (``close``
          still fails them: the queue is gone);
        * **ordered by admission time** — each request is inserted into
          its bucket's FIFO by ``t_enqueue``, so a retried request rejoins
          AHEAD of fresh requests that arrived after it (crashes must not
          also cost queue position);
        * **deduplicated** — a request already present in its bucket
          (identity) or already resolved (its future is done: poisoned,
          deadline-failed, or raced to completion) is skipped, so no
          request can be dispatched twice.
        """
        requeued = 0
        with self._cond:
            if self._closed:
                failed = [r for r in reqs if not r.future.done()]
            else:
                failed = []
                for r in reqs:
                    if r.future.done():
                        continue
                    fifo = self._buckets.setdefault(r.group_key, [])
                    if any(q is r for q in fifo):
                        continue
                    keys = [q.t_enqueue for q in fifo]
                    fifo.insert(bisect.bisect_right(keys, r.t_enqueue), r)
                    self._depth += 1
                    requeued += 1
                self.metrics.queue_depth.set(self._depth)
                if requeued:
                    self._cond.notify_all()
        for r in failed:
            r.future.set_exception(
                Overloaded("service shut down before this request could "
                           "be retried", draining=True))
        return requeued

    # ----------------------------------------------------------------- pop
    def _oldest_bucket(self, want=None) -> Optional[Tuple]:
        key, oldest = None, None
        for k, reqs in self._buckets.items():
            if want is not None and not want(k):
                continue
            if reqs and (oldest is None or reqs[0].t_enqueue < oldest):
                key, oldest = k, reqs[0].t_enqueue
        return key

    def _edf_bucket(self, want=None) -> Optional[Tuple]:
        """EDF group selection: the group holding the globally smallest
        ``edf_key`` (earliest deadline; enqueue stamp for deadline-less
        requests, which therefore sort ahead of any later stream
        flood)."""
        key, best = None, None
        for k, reqs in self._buckets.items():
            if want is not None and not want(k):
                continue
            if not reqs:
                continue
            head = min(edf_key(r) for r in reqs)
            if best is None or head < best:
                key, best = k, head
        return key

    def _edf_slack_end_locked(self, group_key: Tuple,
                              reqs: List[Request], now: float,
                              sizes: Sequence[int]) -> float:
        est = 0.0
        if self._latency_fn is not None:
            measured = self._latency_fn(group_key, sizes[-1])
            if measured is not None:
                est = float(measured)
        return edf_slack_end(reqs, now, self.edf_max_slack_s, est)

    def pop(self, timeout: Optional[float] = None, want=None,
            sizes: Optional[Sequence[int]] = None
            ) -> Optional[List[Request]]:
        """Take the next dispatch batch, blocking until one is available.

        Returns the oldest bucket's head ``pick_batch_size(depth)``
        requests with deadline-expired ones triaged out (their futures
        fail with ``DeadlineExceeded``), or None when the queue is closed
        (worker shutdown) or ``timeout`` elapsed.  The survivors are
        counted into ``metrics.inflight`` before the lock drops, so
        ``drain``'s depth==0 + inflight==0 check never misses a batch in
        hand.

        ``want`` (group-key predicate) restricts which groups this
        caller may take — how the engine keeps mesh-sharded xl work on
        the xl device groups and everything else on the solo workers
        without a second queue (one admission bound, one depth gauge,
        one drain).  ``sizes`` overrides the batch-size ladder for this
        pop (xl buckets compile their own, typically shorter, ladder)."""
        deadline = None if timeout is None else self._clock() + timeout
        sizes = self.sizes if sizes is None else tuple(sizes)
        while True:
            with self._cond:
                while not self._closed and (
                        self._paused or self._oldest_bucket(want) is None):
                    remaining = (None if deadline is None
                                 else deadline - self._clock())
                    if remaining is not None and remaining <= 0:
                        return None
                    self._cond.wait(timeout=remaining)
                if self._closed:
                    return None
                if self.edf:
                    key = self._edf_bucket(want)
                    reqs = self._buckets[key]
                    now_edf = self._clock()
                    if len(reqs) < sizes[-1]:
                        # Bounded-slack coalescing: hold this pop open a
                        # beat so concurrent sessions' frames merge into
                        # a bigger compiled batch instead of an idle
                        # worker instantly dispatching batch-1.  The
                        # wake time is absolute (edf_slack_end), so
                        # re-evaluation converges; a submit filling the
                        # largest size notifies and the re-check
                        # dispatches immediately.
                        # Clamped at now + max_slack: the anchors are
                        # absolute (enqueue stamps / deadlines), so with
                        # a well-behaved clock the clamp is a no-op —
                        # it only guards against a stalled or injected
                        # clock turning the wait into a busy loop.
                        wake = min(
                            self._edf_slack_end_locked(
                                key, reqs, now_edf, sizes),
                            now_edf + self.edf_max_slack_s)
                        if wake > now_edf:
                            self.metrics.edf_slack_waits.inc()
                            self._cond.wait(timeout=wake - now_edf)
                            continue   # re-evaluate under the lock
                    k = pick_batch_size(len(reqs), sizes)
                    # Earliest-deadline-first WITHIN the group too: the
                    # popped batch is the k most urgent members (stable
                    # on ties, so FIFO is preserved among equals).
                    order = sorted(range(len(reqs)),
                                   key=lambda i: (edf_key(reqs[i]), i))
                    take = frozenset(order[:k])
                    batch = [reqs[i] for i in sorted(take)]
                    rest = [r for i, r in enumerate(reqs)
                            if i not in take]
                else:
                    key = self._oldest_bucket(want)
                    reqs = self._buckets[key]
                    k = pick_batch_size(len(reqs), sizes)
                    batch, rest = reqs[:k], reqs[k:]
                if rest:
                    self._buckets[key] = rest
                else:
                    del self._buckets[key]
                self._depth -= len(batch)
                self.metrics.queue_depth.set(self._depth)
                # Deadline triage inside the lock's shadow: expired
                # requests never count inflight.
                now = self._clock()
                live = [r for r in batch if not r.expired(now)]
                expired = [r for r in batch if r.expired(now)]
                self.metrics.inflight.inc(len(live))
                self._cond.notify_all()  # wake drain() waiters
            for r in expired:
                self.metrics.deadline_missed.inc()
                r.future.set_exception(DeadlineExceeded(
                    f"deadline passed after "
                    f"{(now - r.t_enqueue) * 1e3:.1f} ms in queue"))
            if live:
                return live
            # every popped request had expired: go take the next batch

    # ------------------------------------------------------------ test hook
    def pause(self) -> None:
        """Stage mode for tests: submits queue up but ``pop`` blocks, so a
        test can build an exact queue depth before releasing the workers."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    # ---------------------------------------------------------------- drain
    def stop_admitting(self) -> None:
        """Flip to draining WITHOUT waiting: fresh submits shed with the
        typed draining ``Overloaded`` while queued work keeps flowing to
        the workers (and crashed dispatches may still ``requeue``).
        ``drain()`` is stop_admitting + wait-for-empty; the engine uses
        this split so its drain can wait on queue depth, inflight count,
        and pending retries as ONE combined condition."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting (submits raise ``Overloaded``) and wait until the
        workers have popped everything queued.  Returns False on timeout.
        Popped batches may still be running on workers — the engine waits
        on ``metrics.inflight`` separately."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while self._depth > 0:
                remaining = (None if deadline is None
                             else deadline - self._clock())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
        return True

    def close(self) -> None:
        """Stop the queue: blocked ``pop`` calls return None (worker
        shutdown), and queued requests (drain not called, or timed out)
        fail with ``Overloaded`` rather than hanging forever."""
        with self._cond:
            self._closed = True
            self._draining = True
            orphans = [r for reqs in self._buckets.values() for r in reqs]
            self._buckets.clear()
            self._depth = 0
            self.metrics.queue_depth.set(0)
            self._cond.notify_all()
        for r in orphans:
            r.future.set_exception(
                Overloaded("service shut down before this request ran",
                           draining=True))


def drain_order(batches: Sequence[Sequence[Request]]) -> List[Request]:
    """Flatten dispatched batches back to admission order (report helper)."""
    return sorted((r for b in batches for r in b), key=lambda r: r.t_enqueue)
