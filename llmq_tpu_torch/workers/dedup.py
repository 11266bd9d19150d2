"""Semantic dedup / outlier / representative filter worker (port of
``llmq_tpu/workers/dedup.py``), in numpy.

Two similarity backends: ``lexical``, hashed character-n-gram TF vectors
(no model), and ``model``, mean-pooled vectors from a checkpoint's
input-embedding table (:class:`ModelEmbedder`), which catches the
paraphrases n-grams cannot. Cosine similarity either way. The worker:

- accumulates jobs into batches of ``batch_size`` and processes per batch;
- three modes: ``dedup`` (drop near-duplicates), ``outliers`` (drop texts
  far from the batch centroid), ``representative`` (keep one text per
  similarity cluster);
- kept jobs produce their text as the result; dropped jobs produce the
  ``DEDUP_DROPPED`` marker (one result per job, for downstream filters);
- flushes a partial batch on shutdown and after a 5 s idle window.

The worker forces ``concurrency >= batch_size``; with a smaller prefetch
the batch could never fill.
"""

from __future__ import annotations

import asyncio
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from llmq_tpu_torch.core.models import Job
from llmq_tpu_torch.utils.aio import reap
from llmq_tpu_torch.utils.hashing import stable_bucket
from llmq_tpu_torch.workers.base import BaseWorker

DROPPED_MARKER = "DEDUP_DROPPED"

_DIM = 4096
_NGRAM = 3
#: names of an input-embedding table in an HF checkpoint
_EMBED_NAMES = ("embed_tokens.weight", "wte.weight", "word_embeddings.weight")


def text_of(job: Job) -> str:
    """The text to compare: the ``text``, ``content`` or ``document``
    extra, else the messages' contents, else the formatted prompt."""
    for field in ("text", "content", "document"):
        extras = job.extras()
        if field in extras and isinstance(extras[field], str):
            return extras[field]
    if job.messages:
        parts = [str(m.get("content", "")) for m in job.messages if m.get("content")]
        if parts:
            return "\n".join(parts)
    if job.prompt is not None:
        return job.get_formatted_prompt()
    return ""


def embed(texts: List[str]) -> np.ndarray:
    """Hashed char-n-gram TF embedding, L2-normalised. The n-gram buckets
    are blake2b's (``stable_bucket``), so every worker of a queue embeds
    a text alike."""
    dim, n = _DIM, _NGRAM
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for i, t in enumerate(texts):
        t = t.lower()
        if len(t) < n:
            t = t + " " * (n - len(t))
        for j in range(len(t) - n + 1):
            out[i, stable_bucket(t[j : j + n], dim)] += 1.0
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    np.divide(out, norms, out=out, where=norms > 0)
    return out


class ModelEmbedder:
    """Text embedding from a language model's input-embedding table:
    tokenize, mean-pool the token vectors, L2-normalise. The table is
    centered first, removing the shared direction that would push every
    cosine similarity toward 1."""

    def __init__(self, tokenize, table: np.ndarray) -> None:
        self._tokenize = tokenize  # str -> List[int]
        table = np.asarray(table, np.float32)
        self._table = table - table.mean(axis=0, keepdims=True)

    @classmethod
    def from_checkpoint(cls, path: str) -> "ModelEmbedder":
        """The embedding table alone (not the model) of a local HF
        checkpoint directory: the first tensor, by name, named like
        ``*embed_tokens.weight`` / ``*wte.weight`` /
        ``*word_embeddings.weight``, read by the port's safetensors reader
        (``engine/weights.py``) and widened to f32."""
        from llmq_tpu_torch.engine.tokenizer import HFTokenizer
        from llmq_tpu_torch.engine.weights import SafetensorsFile, checkpoint_index

        candidates = {key: fname for key, fname in checkpoint_index(path).items()
                      if key.endswith(_EMBED_NAMES)}
        if not candidates:
            raise ValueError(f"no embedding table found under {path}")
        key, fname = sorted(candidates.items())[0]
        f = SafetensorsFile(fname)
        try:
            table = f.get(key).float().numpy().copy()
        finally:
            f.close()
        return cls(HFTokenizer(str(path)).encode, table)

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self._table.shape[1]), np.float32)
        for i, t in enumerate(texts):
            ids = [j for j in self._tokenize(t) if 0 <= j < len(self._table)]
            if ids:
                out[i] = self._table[ids].mean(axis=0)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        np.divide(out, norms, out=out, where=norms > 0)
        return out


def select_keep_mask(vectors: np.ndarray, mode: str, threshold: float) -> np.ndarray:
    """Which rows to keep, per mode. O(b²) cosine similarity on the batch."""
    b = vectors.shape[0]
    if b == 0:
        return np.zeros(0, dtype=bool)
    sims = vectors @ vectors.T
    if mode == "dedup":
        keep = np.ones(b, dtype=bool)
        for i in range(1, b):
            if sims[i, :i][keep[:i]].max(initial=-1.0) >= threshold:
                keep[i] = False  # near-duplicate of an earlier kept text
        return keep
    if mode == "outliers":
        centroid = vectors.mean(axis=0)
        cnorm = np.linalg.norm(centroid)
        if cnorm == 0:
            return np.ones(b, dtype=bool)
        sim_to_centroid = vectors @ (centroid / cnorm)
        # Keep the most central fraction ``threshold`` (0.9: 90 %).
        k = max(1, int(round(b * threshold)))
        order = np.argsort(-sim_to_centroid)
        keep = np.zeros(b, dtype=bool)
        keep[order[:k]] = True
        return keep
    if mode == "representative":
        # Greedy leader clustering at ``threshold``; keep each cluster leader.
        keep = np.zeros(b, dtype=bool)
        leaders: List[int] = []
        for i in range(b):
            if not leaders or sims[i, leaders].max() < threshold:
                leaders.append(i)
                keep[i] = True
        return keep
    raise ValueError(f"Unknown dedup mode: {mode!r}")


@dataclass
class _Pending:
    job: Job
    future: asyncio.Future


class DedupWorker(BaseWorker):
    def __init__(
        self,
        queue: str,
        *,
        batch_size: int = 256,
        mode: str = "dedup",
        threshold: float = 0.9,
        embedding: str = "lexical",
        model: Optional[str] = None,
        **kwargs,
    ) -> None:
        self.batch_size = batch_size
        self.mode = mode
        self.threshold = threshold
        if embedding == "model":
            if not model:
                raise ValueError("--embedding model requires --model PATH")
            self._embed = ModelEmbedder.from_checkpoint(model)
        elif embedding == "lexical":
            self._embed = embed
        else:
            raise ValueError(f"Unknown embedding backend: {embedding!r} (want lexical|model)")
        self.embedding = embedding
        self.idle_flush_s = 5.0
        self._pending: List[_Pending] = []
        self._last_arrival = 0.0
        self._batch_lock: Optional[asyncio.Lock] = None
        self._flusher: Optional[asyncio.Task] = None
        super().__init__(queue, **kwargs)
        self.concurrency = max(self.concurrency, batch_size)

    def _generate_worker_id(self) -> str:
        return f"dedup-{self.mode}-{uuid.uuid4().hex[:8]}"

    async def _initialize_processor(self) -> None:
        self._batch_lock = asyncio.Lock()
        self._flusher = asyncio.ensure_future(self._idle_flush_loop())

    async def _idle_flush_loop(self) -> None:
        """Flush a partial batch once arrivals go idle for idle_flush_s."""
        while True:
            await asyncio.sleep(1.0)
            assert self._batch_lock is not None
            flush: Optional[List[_Pending]] = None
            async with self._batch_lock:
                if (self._pending and asyncio.get_running_loop().time() - self._last_arrival
                        > self.idle_flush_s):
                    flush = self._pending
                    self._pending = []
            if flush:
                self._process_batch(flush)

    async def _process_job(self, job: Job) -> str:
        """Queue the job into the current batch; resolves when the batch
        (or a shutdown flush) processes it."""
        assert self._batch_lock is not None
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        flush: Optional[List[_Pending]] = None
        async with self._batch_lock:
            self._pending.append(_Pending(job, fut))
            self._last_arrival = asyncio.get_running_loop().time()
            if len(self._pending) >= self.batch_size:
                flush = self._pending
                self._pending = []
        if flush is not None:
            self._process_batch(flush)
        return await fut

    def _process_batch(self, batch: List[_Pending]) -> None:
        texts = [text_of(p.job) for p in batch]
        keep = select_keep_mask(self._embed(texts), self.mode, self.threshold)
        for pending, kept, text in zip(batch, keep, texts):
            if not pending.future.done():
                pending.future.set_result(text if kept else DROPPED_MARKER)

    async def _cleanup_processor(self) -> None:
        await reap(self._flusher, label="dedup idle flusher")
        self._flusher = None
        assert self._batch_lock is not None
        async with self._batch_lock:
            flush = self._pending
            self._pending = []
        if flush:
            self._process_batch(flush)

    def _engine_stats(self) -> Optional[Dict]:
        return {"mode": self.mode, "embedding": self.embedding,
                "batch_size": self.batch_size, "pending": len(self._pending)}
