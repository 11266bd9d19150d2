"""Durable on-disk broker: ``file:///path/to/broker-dir`` (port of
``llmq_tpu/broker/filebroker.py``; same layout and file format, so a
reference process and a port process can share one directory).

Multi-process, single-node job distribution with zero daemons — the
durability story of the reference's RabbitMQ (durable queues + persistent
messages, broker.py:70-78,120-124) implemented on the filesystem:

- A message is one JSON file. Publish = atomic write (tmp + rename) into
  ``<root>/<queue>/ready/``.
- Claim = ``os.rename`` into ``<root>/<queue>/claimed/<owner>/`` — atomic on
  POSIX, so exactly one process wins a message even with many competing
  consumers (the queue *is* the load balancer, as in the reference).
- Ack = delete the claimed file. Reject-requeue = bump ``delivery_count`` and
  rename back to ready (or to ``<q>.failed`` past the redelivery cap).
- Crash recovery: a dead worker leaves files in its claimed dir; a janitor
  pass requeues claims whose owner PID is gone or whose lease expired —
  at-least-once, like an AMQP connection drop requeuing unacked messages.

File names sort by enqueue time so FIFO ordering is approximate (same
guarantee class as a competing-consumer AMQP queue).
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional

from llmq_tpu_torch.broker.base import (
    Broker,
    DeliveredMessage,
    MessageHandler,
    StoredMessage,
    new_message_id,
)
from llmq_tpu_torch.broker.memory import DEFAULT_MAX_REDELIVERIES, FAILED_SUFFIX
from llmq_tpu_torch.core.models import QueueStats
from llmq_tpu_torch.utils.aio import reap, reap_all, spawn, wait_drained

POLL_INTERVAL_S = 0.05
CLAIM_LEASE_S = 600.0


def _queue_dirname(queue: str) -> str:
    # Queue names contain dots (pipeline.<n>.<stage>); keep them readable but
    # guard against path tricks.
    if "/" in queue or queue.startswith("."):
        raise ValueError(f"Invalid queue name: {queue!r}")
    return queue


class FileBroker(Broker):
    def __init__(self, url: str) -> None:
        self.url = url
        path = url.split("://", 1)[1] if "://" in url else url
        self.root = Path(path)
        self.owner = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self._consumers: Dict[str, asyncio.Task] = {}
        self._handler_tasks: set = set()  # strong refs to in-flight handlers
        self._declared: set = set()  # skip per-publish mkdir/meta churn
        self._connected = False

    # --- layout -----------------------------------------------------------
    def _qdir(self, queue: str) -> Path:
        return self.root / "queues" / _queue_dirname(queue)

    def _ready(self, queue: str) -> Path:
        return self._qdir(queue) / "ready"

    def _claimed(self, queue: str) -> Path:
        return self._qdir(queue) / "claimed" / self.owner

    def _meta_path(self, queue: str) -> Path:
        return self._qdir(queue) / "meta.json"

    def _load_meta(self, queue: str) -> Dict[str, object]:
        try:
            return json.loads(self._meta_path(queue).read_text())
        except (OSError, json.JSONDecodeError):
            return {}

    # --- lifecycle --------------------------------------------------------
    async def connect(self) -> None:
        (self.root / "queues").mkdir(parents=True, exist_ok=True)
        self._connected = True

    async def close(self) -> None:
        for tag in list(self._consumers):
            await self.cancel(tag)
        # Give in-flight handlers a short drain window, then cancel; the
        # janitor requeues anything left claimed, so this is at-least-once.
        await wait_drained(self._handler_tasks, timeout=5.0)
        await reap_all(self._handler_tasks, label="file handler task")
        self._connected = False

    async def declare_queue(
        self,
        name: str,
        *,
        durable: bool = True,
        ttl_ms: Optional[int] = None,
        max_redeliveries: Optional[int] = None,
    ) -> None:
        if name in self._declared and ttl_ms is None and max_redeliveries is None:
            return
        self._ready(name).mkdir(parents=True, exist_ok=True)
        (self._qdir(name) / "claimed").mkdir(parents=True, exist_ok=True)
        self._declared.add(name)
        meta = self._load_meta(name)
        if ttl_ms is not None:
            meta["ttl_ms"] = ttl_ms
        if max_redeliveries is not None:
            meta["max_redeliveries"] = max_redeliveries
        if meta:
            tmp = self._meta_path(name).with_suffix(".tmp")
            # Deliberate sync I/O: meta files are tens of bytes, written once
            # per queue declaration — not worth a thread hop.
            tmp.write_text(json.dumps(meta))  # llmq: ignore[blocking-async-io]
            tmp.replace(self._meta_path(name))

    # --- publish ----------------------------------------------------------
    async def publish(
        self,
        queue: str,
        body: bytes,
        *,
        message_id: Optional[str] = None,
        headers: Optional[Dict[str, object]] = None,
    ) -> None:
        await self.declare_queue(queue)
        msg = StoredMessage(
            body=body,
            message_id=message_id or new_message_id(),
            headers=dict(headers or {}),
        )
        self._write_ready(queue, msg)

    def _write_ready(self, queue: str, msg: StoredMessage) -> None:
        ready = self._ready(queue)
        ready.mkdir(parents=True, exist_ok=True)
        fname = f"{time.time_ns():020d}-{msg.message_id}.json"
        tmp = ready / f".tmp-{fname}"
        tmp.write_text(msg.to_json())
        tmp.replace(ready / fname)

    # --- claim/settle -----------------------------------------------------
    def _try_claim(self, queue: str) -> Optional[Path]:
        ready = self._ready(queue)
        claimed = self._claimed(queue)
        claimed.mkdir(parents=True, exist_ok=True)
        try:
            names = sorted(os.listdir(ready))
        except FileNotFoundError:
            return None
        for name in names:
            if name.startswith("."):
                continue
            target = claimed / name
            try:
                os.rename(ready / name, target)
                return target
            except (FileNotFoundError, OSError):
                continue  # lost the race; try the next message
        return None

    def _settle_file(self, queue: str, path: Path, msg: StoredMessage):
        async def settle(verb: str, requeue: bool) -> None:
            meta = self._load_meta(queue)
            cap = int(meta.get("max_redeliveries", DEFAULT_MAX_REDELIVERIES))
            if verb == "reject" and requeue:
                msg.delivery_count += 1
                if msg.delivery_count > cap and not queue.endswith(FAILED_SUFFIX):
                    msg.headers["x-death-queue"] = queue
                    msg.headers["x-delivery-count"] = msg.delivery_count
                    self._write_ready(queue + FAILED_SUFFIX, msg)
                else:
                    self._write_ready(queue, msg)
            try:
                path.unlink()
            except FileNotFoundError:
                pass

        return settle

    def _delivered_from(self, queue: str, path: Path) -> Optional[DeliveredMessage]:
        try:
            msg = StoredMessage.from_json(path.read_text())
        except (OSError, json.JSONDecodeError):
            return None
        meta = self._load_meta(queue)
        ttl_ms = meta.get("ttl_ms")
        if ttl_ms is not None and (time.time() - msg.enqueued_at) * 1000 > float(
            str(ttl_ms)
        ):
            try:
                path.unlink()
            except FileNotFoundError:
                pass
            return None
        return DeliveredMessage(
            msg.body,
            msg.message_id,
            delivery_count=msg.delivery_count,
            headers=msg.headers,
            _settle=self._settle_file(queue, path, msg),
        )

    # --- janitor: requeue claims of dead/stale owners ----------------------
    def _janitor(self, queue: str) -> None:
        claimed_root = self._qdir(queue) / "claimed"
        try:
            owners = os.listdir(claimed_root)
        except FileNotFoundError:
            return
        now = time.time()
        for owner in owners:
            if owner == self.owner:
                continue
            owner_dir = claimed_root / owner
            pid_alive = _owner_alive(owner)
            try:
                files = os.listdir(owner_dir)
            except FileNotFoundError:
                continue
            for name in files:
                fpath = owner_dir / name
                stale = not pid_alive
                if not stale:
                    try:
                        stale = now - fpath.stat().st_mtime > CLAIM_LEASE_S
                    except FileNotFoundError:
                        continue
                if stale:
                    try:
                        msg = StoredMessage.from_json(fpath.read_text())
                        msg.delivery_count += 1
                        meta = self._load_meta(queue)
                        cap = int(
                            meta.get("max_redeliveries", DEFAULT_MAX_REDELIVERIES)
                        )
                        if msg.delivery_count > cap and not queue.endswith(
                            FAILED_SUFFIX
                        ):
                            # Crash-looping job: dead-letter instead of
                            # bouncing between dying workers forever.
                            msg.headers["x-death-queue"] = queue
                            msg.headers["x-delivery-count"] = msg.delivery_count
                            self._write_ready(queue + FAILED_SUFFIX, msg)
                        else:
                            self._write_ready(queue, msg)
                        fpath.unlink()
                    except (OSError, json.JSONDecodeError):
                        continue

    # --- consume ----------------------------------------------------------
    async def consume(
        self, queue: str, handler: MessageHandler, *, prefetch: int = 1
    ) -> str:
        await self.declare_queue(queue)
        tag = f"file-ctag-{uuid.uuid4().hex[:8]}"
        sem = asyncio.Semaphore(max(1, prefetch))

        async def loop() -> None:
            last_janitor = 0.0
            while True:
                now = time.monotonic()
                if now - last_janitor > 5.0:
                    self._janitor(queue)
                    last_janitor = now
                await sem.acquire()
                path = self._try_claim(queue)
                if path is None:
                    sem.release()
                    await asyncio.sleep(POLL_INTERVAL_S)
                    continue
                delivered = self._delivered_from(queue, path)
                if delivered is None:
                    sem.release()
                    continue

                async def run(d: DeliveredMessage = delivered) -> None:
                    try:
                        await handler(d)
                    except Exception:  # noqa: BLE001
                        await d.reject(requeue=True)
                    finally:
                        sem.release()

                spawn(
                    run(),
                    registry=self._handler_tasks,
                    name=f"file-handler:{queue}",
                )

        self._consumers[tag] = asyncio.ensure_future(loop())
        return tag

    async def cancel(self, consumer_tag: str, *, requeue: bool = True) -> None:
        # requeue is moot here: the file broker's claims carry a lease, so
        # anything unsettled when the loop stops is re-claimed on expiry
        # either way.
        await reap(
            self._consumers.pop(consumer_tag, None), label="file consume loop"
        )

    async def get(self, queue: str) -> Optional[DeliveredMessage]:
        await self.declare_queue(queue)
        path = self._try_claim(queue)
        if path is None:
            return None
        return self._delivered_from(queue, path)

    # --- observability ----------------------------------------------------
    async def stats(self, queue: str) -> QueueStats:
        qdir = self._qdir(queue)
        if not qdir.exists():
            return QueueStats(queue_name=queue, stats_source="unavailable")
        ready_files = _list_files(self._ready(queue))
        claimed_root = qdir / "claimed"
        claimed_files: List[Path] = []
        try:
            for owner in os.listdir(claimed_root):
                claimed_files.extend(_list_files(claimed_root / owner))
        except FileNotFoundError:
            pass
        ready_b = _total_size(ready_files)
        unacked_b = _total_size(claimed_files)
        return QueueStats(
            queue_name=queue,
            message_count=len(ready_files) + len(claimed_files),
            message_count_ready=len(ready_files),
            message_count_unacknowledged=len(claimed_files),
            consumer_count=None,  # cross-process consumer census not tracked
            message_bytes=ready_b + unacked_b,
            message_bytes_ready=ready_b,
            message_bytes_unacknowledged=unacked_b,
            stats_source="file_broker",
        )

    async def purge(self, queue: str) -> int:
        ready = self._ready(queue)
        n = 0
        for f in _list_files(ready):
            try:
                f.unlink()
                n += 1
            except FileNotFoundError:
                pass
        return n

    async def delete_queue(self, name: str) -> None:
        self._declared.discard(name)
        try:
            shutil.rmtree(self._qdir(name))
        except OSError:  # gone already, or writers racing the removal: best-effort
            pass


def _list_files(d: Path) -> List[Path]:
    try:
        return [d / n for n in os.listdir(d) if not n.startswith(".")]
    except FileNotFoundError:
        return []


def _total_size(files: List[Path]) -> int:
    total = 0
    for f in files:
        try:
            total += f.stat().st_size
        except FileNotFoundError:
            pass
    return total


def _owner_alive(owner: str) -> bool:
    """Owner dirs are named ``<pid>-<uuid>``; liveness = that PID exists."""
    pid_str = owner.split("-", 1)[0]
    if not pid_str.isdigit():
        return True  # unknown format: be conservative, don't steal
    try:
        os.kill(int(pid_str), 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
