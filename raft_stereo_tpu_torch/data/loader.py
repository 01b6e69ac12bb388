"""Host-side batch loader: shuffled, prefetching, fault-isolated (the
JAX package's ``data/loader.py``).

Decode and augmentation run on host threads or spawned worker processes
while the card steps; batches are stacked NHWC numpy dicts, uploaded by
the train loop's prefetcher (training/train_loop.py).

Determinism: the epoch-``e`` permutation comes from ``seed + e`` and each
sample's augmentation RNG from ``(seed, epoch, index)`` (datasets.py), so
a batch is a pure function of (seed, epoch, indices) whatever the worker
flavor: the port's batches equal the JAX package's bit for bit.

* **Fault isolation**: a sample whose decode raises is retried once and
  then quarantined; a deterministic substitute fills its slot, the sample
  joins a persisted quarantine list (``quarantine_path``, keyed by content
  hash), and ``stats`` counts every decision.  A dead process worker is
  respawned and its in-flight batches resubmitted.
* **Exact resume**: ``state()``/``set_state()`` round-trip the position as
  a flat batch offset (``epoch * len(self) + batch``) plus the rewind
  reshuffle salts: a salt event ``(epoch, batch, salt)`` re-permutes the
  rest of that epoch's order, so a rewind does not replay its poison
  batch.

The module imports no torch: spawned decode workers unpickle the dataset
by importing its module, and must neither pay for torch nor touch CUDA.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from raft_stereo_tpu_torch.data.datasets import StereoDataset

log = logging.getLogger(__name__)

# One retry before quarantine: transient NFS hiccups succeed on the second
# read; a truly corrupt sample fails twice and is pulled from rotation.
SAMPLE_RETRIES = 1

# A worker pool that breaks this many times consecutively is not going to
# heal by respawning (e.g. the dataset itself segfaults every decode).
MAX_POOL_RESPAWNS = 3


class LoaderBroken(RuntimeError):
    """Typed terminal loader failure: the worker pool kept dying after
    ``MAX_POOL_RESPAWNS`` consecutive respawns — respawning is not going
    to converge, a human needs to look at the dataset/host."""


def sample_content_key(dataset, index: int) -> Optional[str]:
    """Stable identity of a sample: SHA-256 over its file paths + sizes.

    Quarantine entries persist under THIS key, not the raw index — a
    re-listed dataset (files added/removed, indices shifted) keeps its
    quarantine aimed at the same bad files, and a REPLACED file (a
    re-downloaded fixed shard: different size) stops matching and leaves
    quarantine automatically.  None when the dataset exposes no
    ``sample_paths`` (synthetic/test datasets) — those entries fall back
    to index identity.
    """
    paths_fn = getattr(dataset, "sample_paths", None)
    if paths_fn is None:
        return None
    try:
        paths = paths_fn(int(index))
    except Exception:
        return None
    h = hashlib.sha256()
    for p in paths:
        try:
            size = os.path.getsize(p)
        except OSError:
            size = -1      # missing file is still a stable identity
        h.update(f"{p}\x00{size}\x00".encode())
    return h.hexdigest()


def _collate(dataset: StereoDataset, epoch: int, indices
             ) -> Dict[str, np.ndarray]:
    """THE batch-assembly contract — every worker flavor (sync, thread,
    process) builds batches through this one function."""
    samples = [dataset.__getitem__(int(i), epoch) for i in indices]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _substitute_index(i: int, n: int, quarantined) -> int:
    """Deterministic replacement for a quarantined sample: the next
    non-quarantined index (wrapping).  Pure function of (i, n, quarantine
    set), so every worker flavor picks the same substitute."""
    for k in range(1, n):
        j = (i + k) % n
        if j not in quarantined:
            return j
    raise LoaderBroken(f"all {n} dataset samples quarantined")


def _collate_isolated(dataset: StereoDataset, epoch: int, indices,
                      quarantined=frozenset(),
                      retries: int = SAMPLE_RETRIES
                      ) -> Tuple[Dict[str, np.ndarray], List[Dict]]:
    """``_collate`` with per-sample fault isolation.

    Returns ``(batch, events)``: each raising sample is retried
    ``retries`` times, then replaced by its deterministic substitute and
    reported as a ``quarantined`` event (a retry that SUCCEEDS reports
    ``retried``).  Already-quarantined indices substitute immediately.
    Events flow back to the owning loader (any worker flavor), which
    merges them into the shared quarantine set + typed counters.
    """
    events: List[Dict] = []
    samples = []
    n = len(dataset)
    for i in indices:
        i = int(i)
        use = i
        if use in quarantined:
            use = _substitute_index(use, n, quarantined)
        sample = None
        local_quarantine = set(quarantined)
        while sample is None:
            try:
                sample = dataset.__getitem__(use, epoch)
            except Exception as e:
                retried = False
                for _ in range(retries):
                    try:
                        sample = dataset.__getitem__(use, epoch)
                        retried = True
                        break
                    except Exception:
                        continue
                if retried:
                    events.append({"kind": "retried", "index": use,
                                   "error": repr(e)})
                    break
                events.append({"kind": "quarantined", "index": use,
                               "error": repr(e)})
                local_quarantine.add(use)
                use = _substitute_index(use, n, local_quarantine)
        samples.append(sample)
    return ({k: np.stack([s[k] for s in samples]) for k in samples[0]},
            events)


# --------------------------------------------------- process-worker plumbing
# Module-level so child processes (spawn) can import it; the dataset is
# shipped once via the pool initializer, not per task.
_WORKER_DATASET: Optional[StereoDataset] = None
_WORKER_QUARANTINE: set = set()


def _process_worker_init(ds_bytes: bytes, quarantined=()) -> None:
    global _WORKER_DATASET, _WORKER_QUARANTINE
    _WORKER_DATASET = pickle.loads(ds_bytes)
    _WORKER_QUARANTINE = set(quarantined)


def _process_make_batch(args):
    epoch, indices = args
    batch, events = _collate_isolated(_WORKER_DATASET, epoch, indices,
                                      quarantined=_WORKER_QUARANTINE)
    # Keep the worker-local view current so later batches in THIS worker
    # substitute immediately; the parent merges events into the shared
    # set and ships it to fresh workers at (re)spawn.
    for ev in events:
        if ev["kind"] == "quarantined":
            _WORKER_QUARANTINE.add(ev["index"])
    return batch, events


_readers_logged = False


def _log_readers() -> None:
    """Say once per process, at WARNING, which readers decode the
    samples: the native decoders (built on this first call) or the Python
    readers, with the reason the native ones are unavailable."""
    global _readers_logged
    if _readers_logged:
        return
    _readers_logged = True
    from raft_stereo_tpu_torch import native
    if native.available():
        log.warning("StereoLoader decodes PNG and PFM with the native "
                    "decoders (%s)", native.library_path().name)
    else:
        log.warning("StereoLoader decodes with the Python readers: native "
                    "decoders unavailable: %s",
                    native.unavailable_reason())


class StereoLoader:
    """Iterate device-ready batches forever (training) or one epoch (eval).

    Args:
      dataset: a ``StereoDataset`` (samples must share one crop size).
      batch_size: the GLOBAL batch size; ``drop_last`` semantics always
        on.  With ``process_count`` > 1 each process yields only its
        contiguous slice of every global batch
        (``parallel/distributed.loader_shard_kwargs``).
      shuffle: re-permute every epoch with ``seed + epoch``.
      num_workers: decode threads; 0 = synchronous in-caller decode.
      prefetch: max ready batches buffered ahead.
      epochs: None = loop forever.
      quarantine_path: JSON file persisting quarantined sample indices
        across restarts (None = in-memory only); loaded at construction,
        rewritten on every new quarantine.
      fault_isolation: retry-once-then-quarantine raising samples and
        respawn dead process workers (default on).  Off = a raising
        sample propagates to the consumer.
    """

    def __init__(self, dataset: StereoDataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 1234,
                 epochs: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1,
                 worker_type: str = "thread",
                 quarantine_path: Optional[str] = None,
                 fault_isolation: bool = True):
        if len(dataset) < batch_size:
            raise ValueError(
                f"dataset has {len(dataset)} samples < batch_size={batch_size}")
        if batch_size % process_count:
            raise ValueError(f"batch_size={batch_size} not divisible by "
                             f"process_count={process_count}")
        if not (0 <= process_index < process_count):
            raise ValueError(f"process_index={process_index} out of range "
                             f"for process_count={process_count}")
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type={worker_type!r} not in "
                             f"('thread', 'process')")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.epochs = epochs
        self.process_index = process_index
        self.process_count = process_count
        # "process": decode+augment in spawned worker PROCESSES — sidesteps
        # the GIL entirely where thread workers only overlap the
        # GIL-releasing segments (native decode, cv2).  Costs one extra
        # batch copy (pickle over the pipe) per batch, so it pays off on
        # multi-core hosts where augment's pure-NumPy Python dominates.
        # Determinism is identical: a batch is a pure function of
        # (seed, epoch, indices) regardless of which worker builds it.
        # NOTE: like any spawn-based pool (torch DataLoader included), the
        # launching script must be import-safe — iteration from a script
        # without an ``if __name__ == "__main__"`` guard re-executes that
        # script in every worker.
        self.worker_type = worker_type
        self.fault_isolation = fault_isolation
        self.quarantine_path = quarantine_path
        # Shared fault state: guarded by _fault_lock (thread workers write
        # concurrently); counters are the typed telemetry surface the
        # train loop mirrors into train_loader_* instruments.
        self._fault_lock = threading.Lock()
        self.quarantined: set = set()
        # index -> content key (sample_content_key; None for datasets
        # without file identity).  The persisted file stores the KEYS —
        # the index is just a verification hint for the fast reload path.
        self._quarantine_keys: Dict[int, Optional[str]] = {}
        self.stats: Dict[str, int] = {"retried": 0, "quarantined": 0,
                                      "worker_respawns": 0}
        if quarantine_path and os.path.exists(quarantine_path):
            try:
                with open(quarantine_path) as f:
                    payload = json.load(f)
                self._load_quarantine(payload)
                log.info("loaded %d quarantined samples from %s",
                         len(self.quarantined), quarantine_path)
            except (OSError, ValueError, TypeError, KeyError):
                log.warning("unreadable quarantine file %s; starting empty",
                            quarantine_path)
        # Exact-resume position: the NEXT batch yielded by a fresh
        # iterator is global batch offset ``start_offset`` (epoch =
        # offset // len(self), batch = offset % len(self)); ``salts``
        # are the rewind reshuffle events (epoch, batch, salt).
        self.start_offset = 0
        self.salts: Tuple[Tuple[int, int, int], ...] = ()

    # --------------------------------------------------- quarantine persist
    def _load_quarantine(self, payload: Dict) -> None:
        """Rebuild the quarantine set from a persisted payload.

        v2 format (``{"version": 2, "samples": [{"key", "index"}, ...]}``)
        stores content keys with the index as a verification hint: a key
        that still matches its recorded index adopts it directly; a
        mismatch (re-listed dataset) triggers ONE full relocation scan; a
        key found nowhere is dropped — the bad file was replaced or
        removed, so the sample re-earns its quarantine or rejoins
        rotation.  The legacy v1 format (``{"indices": [...]}``) is
        migrated in place: indices adopt as-is, their keys are computed
        now, and the next persist rewrites the file as v2.
        """
        n = len(self.dataset)
        if payload.get("version") == 2:
            relocate: List[str] = []
            for ent in payload.get("samples", ()):
                key, idx = ent.get("key"), ent.get("index")
                if key is None:
                    # No file identity when persisted — index is all we have.
                    if isinstance(idx, int) and 0 <= idx < n:
                        self.quarantined.add(idx)
                        self._quarantine_keys[idx] = None
                    continue
                if (isinstance(idx, int) and 0 <= idx < n
                        and sample_content_key(self.dataset, idx) == key):
                    self.quarantined.add(idx)
                    self._quarantine_keys[idx] = key
                else:
                    relocate.append(key)
            if relocate:
                wanted = set(relocate)
                for i in range(n):
                    k = sample_content_key(self.dataset, i)
                    if k in wanted:
                        self.quarantined.add(i)
                        self._quarantine_keys[i] = k
                        wanted.discard(k)
                        if not wanted:
                            break
                log.warning(
                    "quarantine relocation: %d/%d shifted samples "
                    "re-matched by content key, %d dropped (file "
                    "replaced/removed)", len(relocate) - len(wanted),
                    len(relocate), len(wanted))
        else:   # legacy v1: raw indices — adopt, compute keys, migrate
            for i in payload.get("indices", ()):
                i = int(i)
                if 0 <= i < n:
                    self.quarantined.add(i)
                    self._quarantine_keys[i] = sample_content_key(
                        self.dataset, i)
            if self.quarantined:
                log.info("migrating legacy index-keyed quarantine file "
                         "(%d entries) to content-hash keys",
                         len(self.quarantined))
                self._write_quarantine(
                    [{"index": i, "key": self._quarantine_keys.get(i)}
                     for i in sorted(self.quarantined)])

    def _write_quarantine(self, entries: List[Dict]) -> None:
        if not self.quarantine_path:
            return
        try:
            tmp = f"{self.quarantine_path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"version": 2, "samples": entries}, f)
                f.write("\n")
            os.replace(tmp, self.quarantine_path)
        except OSError:  # pragma: no cover - unwritable quarantine dir
            log.warning("could not persist quarantine list to %s",
                        self.quarantine_path)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size  # drop_last

    # ------------------------------------------------------- resume state
    def state(self, consumed: int = 0) -> Dict[str, Any]:
        """Serializable position after ``consumed`` batches of the current
        iterator: feed to ``set_state`` (or the checkpoint runtime blob)
        to resume with a bitwise-identical data order."""
        return {"offset": self.start_offset + consumed,
                "salts": [list(s) for s in self.salts]}

    def set_state(self, state: Dict[str, Any]) -> None:
        """Position the NEXT ``iter()`` at ``state`` (a ``state()`` dict).
        Live iterators are unaffected — the train loop closes its
        prefetcher and re-iterates after calling this."""
        self.start_offset = int(state.get("offset", 0))
        self.salts = tuple((int(e), int(b), int(s))
                           for e, b, s in state.get("salts", ()))

    def add_salt(self, epoch: int, batch: int, salt: int) -> None:
        """Append a rewind reshuffle event: the order of epoch ``epoch``
        from batch ``batch`` on is re-permuted with ``salt`` (consumed
        prefix untouched, still no within-epoch sample repeats) — the
        poison batch that triggered the rewind lands somewhere else."""
        self.salts = self.salts + ((int(epoch), int(batch), int(salt)),)

    # -------------------------------------------------------- batch order
    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(
                len(self.dataset))
        else:
            order = np.arange(len(self.dataset))
        # Salt events apply in arrival order even with shuffle off — a
        # rewind must perturb the order either way, that is its point.
        for e, b, s in self.salts:
            if e != epoch:
                continue
            cut = b * self.batch_size
            rng = np.random.default_rng([self.seed, epoch, b, s])
            order = np.concatenate([order[:cut],
                                    rng.permutation(order[cut:])])
        return order

    def _make_batch(self, epoch: int, indices: np.ndarray
                    ) -> Dict[str, np.ndarray]:
        if not self.fault_isolation:
            return _collate(self.dataset, epoch, indices)
        with self._fault_lock:
            quarantined = frozenset(self.quarantined)
        batch, events = _collate_isolated(self.dataset, epoch, indices,
                                          quarantined=quarantined)
        self._note_fault_events(events)
        return batch

    def _note_fault_events(self, events: Sequence[Dict]) -> None:
        if not events:
            return
        dirty = False
        with self._fault_lock:
            for ev in events:
                if ev["kind"] == "retried":
                    self.stats["retried"] += 1
                    log.warning("sample %s raised once and succeeded on "
                                "retry: %s", ev["index"], ev["error"])
                elif ev["kind"] == "quarantined":
                    if ev["index"] not in self.quarantined:
                        self.quarantined.add(ev["index"])
                        self._quarantine_keys[ev["index"]] = (
                            sample_content_key(self.dataset, ev["index"]))
                        self.stats["quarantined"] += 1
                        dirty = True
                    log.warning("sample %s quarantined after retry: %s",
                                ev["index"], ev["error"])
            snapshot = [{"index": i, "key": self._quarantine_keys.get(i)}
                        for i in sorted(self.quarantined)]
        if dirty:
            self._write_quarantine(snapshot)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        _log_readers()
        if self.num_workers <= 0:
            yield from self._iter_sync()
        elif self.worker_type == "process":
            yield from self._iter_process()
        else:
            yield from self._iter_threaded()

    def _batch_indices(self):
        local = self.batch_size // self.process_count
        lo = self.process_index * local
        epoch, start_batch = divmod(self.start_offset, max(1, len(self)))
        while self.epochs is None or epoch < self.epochs:
            order = self._epoch_order(epoch)
            for i in range(start_batch, len(self)):
                global_slice = order[i * self.batch_size:
                                     (i + 1) * self.batch_size]
                yield epoch, global_slice[lo:lo + local]
            start_batch = 0
            epoch += 1

    def _iter_sync(self):
        for epoch, idx in self._batch_indices():
            yield self._make_batch(epoch, idx)

    def _spawn_pool(self):
        import concurrent.futures as cf
        import multiprocessing as mp

        # spawn, not fork: the parent holds a live CUDA context (a forked
        # child of a CUDA process cannot use the card) and torch's thread
        # pools, whose locks must not be duplicated into children
        ctx = mp.get_context("spawn")
        ds_bytes = pickle.dumps(self.dataset)
        with self._fault_lock:
            quarantined = tuple(sorted(self.quarantined))
        return cf.ProcessPoolExecutor(self.num_workers, mp_context=ctx,
                                      initializer=_process_worker_init,
                                      initargs=(ds_bytes, quarantined))

    def _iter_process(self):
        """Spawned worker processes; submission order = yield order (an
        ordered deque of futures doubles as the reorder buffer), with at
        most ``prefetch + num_workers`` batches in flight.

        A BROKEN pool (a worker process died: OOM kill, native decoder
        segfault) is respawned with the current quarantine view and every
        in-flight batch resubmitted in order — the consumer never sees
        the death, only the ``worker_respawns`` counter moving.  After
        ``MAX_POOL_RESPAWNS`` consecutive breakages the loader raises the
        typed ``LoaderBroken`` instead of respawn-looping forever."""
        import collections

        max_ahead = self.prefetch + self.num_workers
        pool = self._spawn_pool()
        try:
            gen = self._batch_indices()
            # Each entry rides (future, args) so a broken pool can
            # resubmit the exact same work to the fresh one.
            inflight: "collections.deque" = collections.deque()
            exhausted = False
            respawns_in_a_row = 0
            while True:
                while not exhausted and len(inflight) < max_ahead:
                    try:
                        epoch, idx = next(gen)
                    except StopIteration:
                        exhausted = True
                        break
                    args = (epoch, idx)
                    inflight.append(
                        (pool.submit(_process_make_batch, args), args))
                if not inflight:
                    return
                fut, args = inflight.popleft()
                try:
                    result = fut.result()
                except BaseException as e:
                    if not (self.fault_isolation
                            and _is_broken_pool_error(e)):
                        raise
                    respawns_in_a_row += 1
                    with self._fault_lock:
                        self.stats["worker_respawns"] += 1
                    log.warning(
                        "loader worker pool died (%r); respawn %d/%d and "
                        "resubmitting %d in-flight batches", e,
                        respawns_in_a_row, MAX_POOL_RESPAWNS,
                        len(inflight) + 1)
                    if respawns_in_a_row > MAX_POOL_RESPAWNS:
                        raise LoaderBroken(
                            f"worker pool died {respawns_in_a_row} times "
                            f"in a row; last error: {e!r}") from e
                    pool.shutdown(wait=False, cancel_futures=True)
                    pool = self._spawn_pool()
                    redo = [args] + [a for _, a in inflight]
                    inflight.clear()
                    for a in redo:
                        inflight.append(
                            (pool.submit(_process_make_batch, a), a))
                    continue
                respawns_in_a_row = 0
                if (isinstance(result, tuple) and len(result) == 2
                        and isinstance(result[1], list)):
                    batch, events = result
                    self._note_fault_events(events)
                else:   # fault_isolation=False workers return bare batches
                    batch = result
                yield batch
        finally:
            # Early close (consumer break / GeneratorExit) must not sit
            # through prefetch+num_workers queued full-frame batches — drop
            # the queue and leave only the in-flight task per worker to
            # drain in the background (e.g. a SIGTERM-triggered checkpoint
            # would otherwise stall multiple seconds here).
            pool.shutdown(wait=False, cancel_futures=True)

    def _iter_threaded(self):
        """Workers claim batch slots from a ticket queue and publish into a
        bounded reorder buffer, so batch order stays deterministic while
        decode runs ahead."""
        tickets: "queue.Queue" = queue.Queue()
        done = threading.Event()
        results: Dict[int, Dict[str, np.ndarray]] = {}
        results_lock = threading.Condition()
        max_ahead = self.prefetch + self.num_workers

        def worker():
            while not done.is_set():
                try:
                    seq, epoch, idx = tickets.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    batch = self._make_batch(epoch, idx)
                except Exception as e:  # surface decode errors to the consumer
                    batch = e
                with results_lock:
                    results[seq] = batch
                    results_lock.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            gen = self._batch_indices()
            issued = 0
            consumed = 0
            exhausted = False
            while True:
                while not exhausted and issued < consumed + max_ahead:
                    try:
                        epoch, idx = next(gen)
                    except StopIteration:
                        exhausted = True
                        break
                    tickets.put((issued, epoch, idx))
                    issued += 1
                if exhausted and consumed == issued:
                    return
                with results_lock:
                    while consumed not in results:
                        results_lock.wait(timeout=0.5)
                    batch = results.pop(consumed)
                consumed += 1
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            done.set()
            # Collect the workers (they poll `done` every 0.1 s): a daemon
            # thread still inside the native decoder at interpreter
            # teardown aborts the process ("terminate called without an
            # active exception"); bounded joins close that window without
            # risking a hang on a stuck decode.
            for t in threads:
                t.join(timeout=2.0)


def _is_broken_pool_error(e: BaseException) -> bool:
    """Whether an exception out of ``Future.result()`` means the POOL
    died (worker process killed) rather than the task raising.  Task
    exceptions cannot occur with fault isolation on — ``_collate_isolated``
    absorbs them — so a raising future is pool death by construction;
    the isinstance check keeps non-isolated semantics exact."""
    import concurrent.futures as cf

    broken = (getattr(cf.process, "BrokenProcessPool", None),
              cf.BrokenExecutor)
    return isinstance(e, tuple(b for b in broken if b is not None))
