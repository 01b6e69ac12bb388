"""Replicated router state: a fenced lease plus an append-only ledger,
both living in the shared artifact store (``<store>/fleet/``).

The r16 router kept two pieces of state that die with its process: the
lost-session set (ids owed exactly one typed 410) and — new this round —
the handoff map (ids whose warm state a draining replica published).
Losing either across a router failover breaks a client-visible contract:
a forgotten loss silently un-types a broken stream, a re-armed one fires
the 410 twice, and a forgotten handoff cold-starts a stream whose warm
state is sitting in the store.  This module replicates exactly that
state between a primary/standby ``raft-route-torch`` pair:

* **Lease** (``lease.json``) — ``{"epoch": E, "owner": name, "t":
  wall}``, rewritten atomically.  The ACTIVE router renews ``t`` on its
  health-loop cadence; the standby watches staleness (and optionally
  probes the primary's URL) and takes over by bumping the epoch.  The
  epoch is the FENCE: every ledger append re-reads the lease and a
  writer holding a stale epoch is rejected — a partitioned ex-primary
  can keep serving reads, but it can never corrupt the replicated
  session-loss record (tests/test_fleet.py pins the rejection).
* **Ledger** (``ledger.jsonl``) — append-only JSON lines, each carrying
  the writer's epoch and a per-writer sequence number.  Record kinds:
  ``lost`` (a replica death tombstoned these sids — the 410s are OWED),
  ``fired`` (one sid's 410 was actually delivered), ``handoff`` (these
  sids' warm state lives at this artifact key).  The standby replays on
  takeover: owed losses minus fired ones re-arm (a client that never
  got its 410 still gets exactly one), fired ones stay fired (never a
  second 410 for one id), handoffs re-arm the warm remap.  Torn tails
  and corrupt lines are skipped — the ledger is an at-least-once
  record, and the in-memory tables it rebuilds are TTL/capacity-bounded
  anyway (``fleet_lost_ledger_size``).

File-level simplicity is deliberate: one writer at a time (the lease
holder), atomic lease replacement, O_APPEND line writes, and replay that
tolerates anything.  The same directory works over the NFS/object-store
mounts the artifact store already assumes.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

LEASE_FILE = "lease.json"
LEDGER_FILE = "ledger.jsonl"


class FleetLedger:
    """Fenced append-only ledger + lease for one router pair.

    ``owner`` names this writer (appears in the lease and every record).
    ``clock`` is wall time (the lease must compare across processes).
    Thread-safe; the router's health loop calls ``renew``/``is_stale``
    every poll and the request path calls ``append``.
    """

    def __init__(self, ledger_dir: str, owner: str, clock=time.time):
        self.dir = os.path.abspath(os.path.expanduser(ledger_dir))
        os.makedirs(self.dir, exist_ok=True)
        self.owner = owner
        self._clock = clock
        self._lock = threading.Lock()
        self.epoch: Optional[int] = None     # held epoch; None = not active
        self._seq = 0
        self.rejected_appends = 0

    # ----------------------------------------------------------------- lease
    @property
    def _lease_path(self) -> str:
        return os.path.join(self.dir, LEASE_FILE)

    @property
    def _ledger_path(self) -> str:
        return os.path.join(self.dir, LEDGER_FILE)

    def read_lease(self) -> Optional[Dict[str, object]]:
        try:
            with open(self._lease_path) as f:
                lease = json.load(f)
            return {"epoch": int(lease["epoch"]),
                    "owner": str(lease["owner"]),
                    "t": float(lease["t"])}
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _write_lease(self, epoch: int) -> None:
        tmp = f"{self._lease_path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "owner": self.owner,
                       "t": self._clock()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._lease_path)

    def acquire(self) -> int:
        """Take (or take OVER) the lease: epoch becomes max(existing)+1,
        which fences every append the previous holder might still
        attempt.  Returns the new epoch."""
        with self._lock:
            lease = self.read_lease()
            epoch = (lease["epoch"] if lease else 0) + 1
            self._write_lease(epoch)
            self.epoch = epoch
            log.info("ledger lease acquired by %s at epoch %d "
                     "(previous: %s)", self.owner, epoch,
                     lease and f"{lease['owner']}@{lease['epoch']}")
            return epoch

    def renew(self) -> bool:
        """Refresh the lease timestamp; False (and the held epoch drops)
        when someone else took the lease — this writer is fenced out and
        must stop appending."""
        with self._lock:
            if self.epoch is None:
                return False
            lease = self.read_lease()
            if lease is None or lease["epoch"] != self.epoch \
                    or lease["owner"] != self.owner:
                log.warning("ledger lease lost by %s (now %s); fenced",
                            self.owner,
                            lease and f"{lease['owner']}@{lease['epoch']}")
                self.epoch = None
                return False
            self._write_lease(self.epoch)
            return True

    def is_stale(self, ttl_s: float) -> bool:
        """Whether the CURRENT lease (whoever holds it) has not been
        renewed within ``ttl_s`` — the standby's takeover trigger.  An
        absent/unreadable lease counts as stale (nobody is active)."""
        lease = self.read_lease()
        if lease is None:
            return True
        if lease["owner"] == self.owner:
            return False
        return self._clock() - lease["t"] > ttl_s

    @property
    def active(self) -> bool:
        return self.epoch is not None

    # ---------------------------------------------------------------- ledger
    def append(self, kind: str, **fields) -> bool:
        """Append one fenced record; False when this writer no longer
        holds the lease epoch (the record is NOT written — the fencing
        contract a stale router's append must hit)."""
        with self._lock:
            if self.epoch is None:
                self.rejected_appends += 1
                return False
            lease = self.read_lease()
            if lease is None or lease["epoch"] != self.epoch:
                self.rejected_appends += 1
                self.epoch = None
                log.warning("ledger append %r rejected: %s holds a "
                            "stale epoch (lease now %s)", kind,
                            self.owner,
                            lease and f"{lease['owner']}@{lease['epoch']}")
                return False
            self._seq += 1
            record = {"epoch": self.epoch, "seq": self._seq,
                      "owner": self.owner, "t": self._clock(),
                      "kind": kind, **fields}
            line = json.dumps(record, sort_keys=True, default=str) + "\n"
            try:
                with open(self._ledger_path, "a") as f:
                    f.write(line)
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                log.warning("ledger append failed", exc_info=True)
                return False
            return True

    def replay(self) -> List[Dict[str, object]]:
        """Every parseable ledger record in append order; torn tails and
        corrupt lines are skipped (the ledger can always be read)."""
        out: List[Dict[str, object]] = []
        try:
            with open(self._ledger_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue    # torn/corrupt line: skip, keep going
        except OSError:
            return out
        return out

    def compact(self, keep_after_t: float) -> int:
        """Rewrite the ledger keeping only records newer than
        ``keep_after_t`` (the active writer's housekeeping so weeks of
        session churn do not grow the file without bound).  Returns the
        number of records dropped; a fenced or failed compaction is a
        no-op."""
        with self._lock:
            if self.epoch is None:
                return 0
            records = self.replay()
            kept = [r for r in records
                    if float(r.get("t", 0)) >= keep_after_t]
            if len(kept) == len(records):
                return 0
            tmp = f"{self._ledger_path}.tmp-{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    for r in kept:
                        f.write(json.dumps(r, sort_keys=True,
                                           default=str) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self._ledger_path)
            except OSError:
                log.warning("ledger compaction failed", exc_info=True)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return 0
            return len(records) - len(kept)
