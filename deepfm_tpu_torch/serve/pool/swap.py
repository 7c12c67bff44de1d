"""Group-atomic hot swap, all members of a shard-group or none: the port's
copy of ``deepfm_tpu/serve/pool/swap.py``, one coordinator per (group,
tenant).

``serve/reload.py`` swaps ONE process; a shard-group is several members
that must never serve different versions to the same traffic (the router
retries across members, so a half-swapped group would score one request's
retry on different weights than its first attempt).  The coordinator runs
the two-phase shape over the members' admin surface (worker.py):

1. **stage everywhere** — every member fetches, hash-verifies, and
   CANARIES the version off-traffic.  Any failure aborts the whole group
   (``/admin:abort`` to every member): nothing was ever live, the group
   stays on the old version and generation (``rollbacks_total``).
2. **commit everywhere** — each member atomically repoints its payload
   and adopts generation G+1 (drain-aware).  A commit can only fail if a
   member died between phases; then every already-committed member is
   ROLLED BACK (``/admin:rollback`` — members retain the pre-commit
   payload for exactly this) and the rest aborted, returning the whole
   group to generation G.

**Version-skew protection across the window**: between the first and last
member commit the group momentarily spans two generations — but the
router pins every request to one generation and members refuse
(409-skew-abort) rather than score a mismatched pin, so no REQUEST ever
observes the mixed state; the window only costs a few re-pinned retries.

**Respawn repair**: a member process that crashed and respawned restarts
at generation 0 serving the BASE servable — stale the moment the group
has ever swapped.  Every poll also runs :meth:`GroupSwapper.repair_once`:
lagging members (read off ``/readyz``) are staged+committed back to the
group's current version at the group's current generation (the member's
commit accepts the forward jump), so a restart costs seconds of staleness
behind an ejected router slot, never a permanently-stale member or a
wedged swap pipeline.

Store-facing discovery (``latest_manifest``) runs behind a circuit
breaker exactly like the single-process HotSwapper: an outage costs one
probe per cooldown while the old weights keep serving.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

from ...online.publisher import latest_manifest
from ...utils.retry import CircuitBreaker


class GroupSwapper:
    """Coordinate group-atomic version swaps for ONE shard-group.

    ``members`` are the members' base URLs (their worker.py admin surface).
    ``poll_once`` is the whole protocol; ``start`` polls on a background
    thread.  ``generation`` mirrors the members' committed group
    generation (they start at 0 and move in lockstep — any divergence is
    a protocol violation the members' successor check catches)."""

    def __init__(
        self,
        members: list[str],
        source: str,
        *,
        group: str = "g0",
        tenant: str | None = None,
        interval_secs: float = 2.0,
        admin_timeout_secs: float = 120.0,
        breaker: CircuitBreaker | None = None,
    ):
        if not members:
            raise ValueError("a shard-group needs at least one member")
        self.group = group
        # one coordinator per (group, tenant): each tenant's publish root is
        # its own manifest stream, staged and committed into that tenant's
        # slots only, so tenant A's swap or rollback cannot touch tenant B
        # (worker.py keys generations and slots by tenant).  None: the
        # tenant-less protocol against single-tenant members
        self.tenant = tenant
        self._members = list(members)
        self._source = str(source)
        self._interval = float(interval_secs)
        self._timeout = float(admin_timeout_secs)
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=0.5, window=6, min_calls=3,
            cooldown_secs=max(5.0, 4.0 * self._interval),
            name=f"swap[{group}]",
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.generation = 0
        self.version = 0
        self.swaps_total = 0
        self.rollbacks_total = 0
        self.repairs_total = 0
        self.poll_errors_total = 0
        self.polls_skipped_total = 0
        self.last_swap_ms: float | None = None
        self.last_error: str | None = None

    # -- member RPC ---------------------------------------------------------
    def _admin(self, member_url: str, verb: str, body: dict) -> dict:
        if self.tenant is not None:
            body = {**body, "tenant": self.tenant}
        req = urllib.request.Request(
            f"{member_url}/admin:{verb}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self._timeout) as r:
            return json.load(r)

    def _admin_quiet(self, member_url: str, verb: str) -> bool:
        """Best-effort abort/rollback leg: a member that is DOWN needs no
        rollback (its restart re-loads the committed-on-disk servable at
        the old version), so failures here are recorded, not raised."""
        try:
            self._admin(member_url, verb, {})
            return True
        except Exception as e:
            # secondary failure on the cleanup leg: keep it visible (the
            # caller's primary error overwrites it, which is the right
            # precedence), never let it mask the abort/rollback sweep
            with self._lock:
                self.last_error = (
                    f"{verb} {member_url}: {type(e).__name__}: {e}"
                )
            return False

    # -- the protocol -------------------------------------------------------
    def swap_to(self, version: int) -> bool:
        """Stage+commit ``version`` across the group, or roll back.
        Returns True only when EVERY member committed."""
        version = int(version)
        staged: list[str] = []
        t0 = time.perf_counter()
        for m in self._members:
            try:
                self._admin(m, "stage", {"version": version,
                                         "source": self._source})
                staged.append(m)
            except Exception as e:
                for s in staged:
                    self._admin_quiet(s, "abort")
                with self._lock:
                    self.rollbacks_total += 1
                    self.last_error = (
                        f"stage {m}: {type(e).__name__}: {e} — group "
                        f"aborted at generation {self.generation}"
                    )
                return False
        new_gen = self.generation + 1
        committed: list[str] = []
        for m in self._members:
            try:
                self._admin(m, "commit", {"generation": new_gen,
                                          "version": version})
                committed.append(m)
            except Exception as e:
                # partial commit: un-commit the committed, abort the rest.
                # The FAILED member gets a rollback too: its commit may
                # have SUCCEEDED with only the response lost (a timeout
                # across the drain window) — left alone it would sit
                # AHEAD of the group and veto every future swap's
                # generation.  If it never committed, the rollback is a
                # refused no-op (_admin_quiet swallows the 409).
                self._admin_quiet(m, "rollback")
                for c in committed:
                    self._admin_quiet(c, "rollback")
                for s in staged:
                    if s not in committed:
                        self._admin_quiet(s, "abort")
                with self._lock:
                    self.rollbacks_total += 1
                    self.last_error = (
                        f"commit {m}: {type(e).__name__}: {e} — group "
                        f"rolled back to generation {self.generation}"
                    )
                return False
        with self._lock:
            self.generation = new_gen
            self.version = version
            self.swaps_total += 1
            self.last_swap_ms = round(1e3 * (time.perf_counter() - t0), 3)
            self.last_error = None
        return True

    def repair_once(self) -> int:
        """Re-converge members that drifted BEHIND the group's committed
        state — a respawned worker restarts at generation 0 serving the
        base servable, which is stale the moment the group has ever
        swapped.  Reads each member's ``/readyz`` (it carries
        ``model_version`` + ``group_generation``) and stages+commits the
        group's CURRENT version at the group's CURRENT generation on any
        lagging member (worker.commit accepts the forward jump).
        Returns how many members were repaired; unreachable members are
        left for the next poll (the router keeps them ejected)."""
        if self.version <= 0:
            return 0
        repaired = 0
        for m in self._members:
            try:
                req = urllib.request.Request(m + "/readyz")
                with urllib.request.urlopen(req, timeout=5) as r:
                    doc = json.load(r)
            except (urllib.error.URLError, OSError, ValueError):
                continue  # down or not ready: the next poll retries
            if self.tenant is not None:
                # a respawned member restarts every tenant at generation 0;
                # each tenant's coordinator repairs its own share
                td = (doc.get("tenants") or {}).get(self.tenant)
                if td is None:
                    continue  # the member predates the tenant: next poll
                gen = int(td.get("generation", -1))
                ver = int(td.get("model_version", -1))
            else:
                gen = int(doc.get("group_generation", -1))
                ver = int(doc.get("model_version", -1))
            if ver == self.version and gen == self.generation:
                continue
            if gen > self.generation:
                # AHEAD of the group: a lost-response commit the failure
                # sweep could not reach — return it to the committed
                # group state (the member retains its pre-commit payload
                # for exactly this)
                if self._admin_quiet(m, "rollback"):
                    repaired += 1
                continue
            try:
                self._admin(m, "stage", {"version": self.version,
                                         "source": self._source})
                self._admin(m, "commit", {"generation": self.generation,
                                          "version": self.version})
                repaired += 1
            except Exception as e:
                with self._lock:
                    self.last_error = (
                        f"repair {m}: {type(e).__name__}: {e}"
                    )
        with self._lock:
            self.repairs_total += repaired
        return repaired

    def poll_once(self) -> bool:
        """Discover the latest committed version; swap the group to it.
        Also runs the member repair pass (``repair_once``) so a
        respawned member re-converges to the group's committed state
        instead of serving the stale base servable forever.  Never
        raises (the HotSwapper discipline: discovery failures feed the
        breaker; swap failures roll back and are counted)."""
        if not self._breaker.allow():
            with self._lock:
                self.polls_skipped_total += 1
            return False
        try:
            manifest = latest_manifest(self._source)
        except Exception as e:
            self._breaker.record_failure()
            with self._lock:
                self.poll_errors_total += 1
                self.last_error = f"poll: {type(e).__name__}: {e}"
            return False
        self._breaker.record_success()
        if manifest is None or manifest.version <= self.version:
            self.repair_once()
            return False
        return self.swap_to(manifest.version)

    # -- background polling -------------------------------------------------
    def start(self) -> "GroupSwapper":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"group-swapper-{self.group}",
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self._interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def status(self) -> dict:
        with self._lock:
            return {
                "group": self.group,
                "tenant": self.tenant,
                "members": len(self._members),
                "generation": self.generation,
                "version": self.version,
                "swaps_total": self.swaps_total,
                "rollbacks_total": self.rollbacks_total,
                "repairs_total": self.repairs_total,
                "poll_errors_total": self.poll_errors_total,
                "polls_skipped_total": self.polls_skipped_total,
                "breaker": self._breaker.status(),
                "last_swap_ms": self.last_swap_ms,
                "last_error": self.last_error,
            }
