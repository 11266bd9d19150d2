"""Worker launcher of the port (counterpart of ``llmq_tpu/cli/worker.py``
``run_tpu_worker`` :15).

``run_torch_worker(MODEL, queue, ...)`` builds the model on the device,
wraps it in an engine and serves ``queue`` from the broker at
``broker_url`` (by default ``LLMQ_BROKER_URL``, ``core/config.py``) until
``max_jobs`` jobs are settled, a signal stops it, or forever. MODEL is
``preset://NAME`` (random weights from a seeded generator, the byte
tokenizer) or an HF checkpoint directory, loaded as the JAX worker's
``_build_core`` (:365-397) loads it: ``ModelConfig.from_pretrained``,
``engine/weights.load_checkpoint`` with the worker's dtype and quantize
mode, ``HFTokenizer``. ``dtype`` is
bfloat16, float32, or int8 / int4: weight-only quantization
(``models/quant.py``) with bf16 compute, as the JAX worker's
``--dtype`` (``tpu_worker.py:351-374``). The KV pool takes ``kv_dtype``
(bf16, f32, fp8), else ``LLMQ_KV_DTYPE`` / ``VLLM_KV_CACHE_DTYPE``, else
the compute dtype. The engine config is resolved as the JAX worker's
``_build_core`` (:333) resolves it (:func:`engine_config`): each argument over
its variable in ``core/config.py``, ``max_model_len`` clamped to the
model's ``max_position_embeddings``, ``prefix_host_gb`` refused without
prefix caching (``tpu_worker.py:190``). ``role`` (unified, prefill,
decode or auto) sets the worker's ``Config.worker_role`` over
``LLMQ_WORKER_ROLE``. The worker's queue and failure policy (job TTL,
redelivery cap, timeout, quarantine, breaker, reconnects) are read from
the environment by ``core/config.py``; the settings of features the port
lacks are refused before any weight is loaded. The command line is
``python -m llmq_tpu_torch worker run MODEL QUEUE`` (``cli/main.py``).

The other launchers of ``llmq_tpu/cli/worker.py``: ``run_dummy_worker``
(the echo worker), ``run_dedup_worker`` (the numpy dedup / filter worker)
and ``run_pipeline_worker``, which serves one stage of a pipeline file
with the worker its type names: ``tpu`` (or the reference's ``vllm``) a
``TorchWorker`` over ``config.model`` with the stage's ``max_model_len``
and ``max_num_seqs`` (the rest at the worker's defaults: bf16 on
``device``), ``dummy`` a ``DummyWorker`` (``delay``), ``dedup`` (or
``semhash``) a ``DedupWorker``; its results go on to the next stage's
queue. These log JSON lines on stdout (``utils/logging.py``), as the
reference's launchers do.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import sys
from pathlib import Path
from typing import Optional

import torch

from llmq_tpu_torch.core.config import Config, get_config
from llmq_tpu_torch.core.pipeline import load_pipeline_config
from llmq_tpu_torch.device import DeviceLike, resolve_device
from llmq_tpu_torch.engine.engine import AsyncEngine, EngineConfig, EngineCore
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer, HFTokenizer
from llmq_tpu_torch.engine.weights import load_checkpoint
from llmq_tpu_torch.models.config import ModelConfig
from llmq_tpu_torch.models.presets import get_preset
from llmq_tpu_torch.models.transformer import init_params
from llmq_tpu_torch.utils.logging import setup_logging
from llmq_tpu_torch.workers.base import BaseWorker
from llmq_tpu_torch.workers.torch_worker import TorchWorker, worker_role

logger = logging.getLogger(__name__)

PRESET_SCHEMES = ("preset://", "random://")
# dtype -> (compute dtype, init_params(quantize=...))
_DTYPES = {"bfloat16": (torch.bfloat16, False), "bf16": (torch.bfloat16, False),
           "float32": (torch.float32, False), "f32": (torch.float32, False),
           "int8": (torch.bfloat16, "int8"), "int4": (torch.bfloat16, "int4")}


# The JAX worker's pool dtype names (``_resolve_pool_dtype``, :314).
_POOL_DTYPES = {"fp8": "float8_e5m2", "fp8_e5m2": "float8_e5m2", "float8_e5m2": "float8_e5m2",
                "bf16": "bfloat16", "bfloat16": "bfloat16", "f32": "float32",
                "float32": "float32"}
DEFAULT_MAX_MODEL_LEN = 8192  # _build_core's default, before the clamp


def resolve_pool_dtype(dtype: str, kv_dtype: Optional[str] = None,
                       config: Optional[Config] = None) -> str:
    """The KV pool dtype, as the JAX worker's ``_resolve_pool_dtype``:
    ``kv_dtype`` > ``LLMQ_KV_DTYPE`` / ``VLLM_KV_CACHE_DTYPE`` > the
    compute dtype (float32 under float32, else bfloat16: int8 and int4
    compute in bf16). A name outside its table is passed on, for
    ``EngineConfig`` to refuse."""
    kv = kv_dtype or (config or get_config()).kv_dtype
    if kv not in (None, "", "auto"):
        return _POOL_DTYPES.get(str(kv).lower(), kv)
    return "float32" if _DTYPES[dtype][0] == torch.float32 else "bfloat16"


def engine_config(
    model_config: ModelConfig,
    *,
    dtype: str = "bfloat16",
    max_num_seqs: Optional[int] = None,
    max_model_len: Optional[int] = None,
    kv_dtype: Optional[str] = None,
    prefill_chunk_size: Optional[int] = None,
    enable_prefix_caching: bool = False,
    prefix_host_gb: Optional[float] = None,
    decode_block: Optional[int] = None,
    spec_tokens: Optional[int] = None,
    mixed_step: Optional[str] = None,
    config: Optional[Config] = None,
) -> EngineConfig:
    """The worker's ``EngineConfig``, field for field as ``_build_core``
    builds it: an argument wins over its variable (``config``, by default
    read from the environment now); ``max_model_len`` is ``min(argument
    or variable or 8192, max_position_embeddings)``. Decode blocks (K >
    1), spec tokens (> 0) and mixed steps (not "off") are set when an
    argument or variable turns them on; tp overlap is passed on when its
    variable turns it on, so the engine refuses it with its ROADMAP.md
    item. ``prefix_host_gb`` is passed on when set (the engine resolves
    ``LLMQ_PREFIX_HOST_GB`` over it), and refused without prefix caching,
    as the JAX worker refuses it before any weight is loaded."""
    cfg = config or get_config()
    caching = enable_prefix_caching or cfg.enable_prefix_caching
    if prefix_host_gb and not caching:
        raise ValueError("--prefix-host-gb requires --prefix-caching: the host tier parks "
                         "pages the device prefix cache evicts")
    overrides = {}
    if max_num_seqs or cfg.max_num_seqs:
        overrides["max_num_seqs"] = max_num_seqs or cfg.max_num_seqs
    overrides["max_model_len"] = min(max_model_len or cfg.max_model_len or DEFAULT_MAX_MODEL_LEN,
                                     model_config.max_position_embeddings)
    chunk = prefill_chunk_size or cfg.prefill_chunk_size
    if chunk:
        overrides["prefill_chunk_size"] = chunk
    if caching:
        overrides["enable_prefix_caching"] = True
    if prefix_host_gb:
        overrides["prefix_host_gb"] = prefix_host_gb
    block = decode_block or cfg.decode_block
    if block and block > 1:
        overrides["decode_block"] = block
    spec = spec_tokens or cfg.spec_tokens
    if spec and spec > 0:
        overrides["spec_tokens"] = spec
    if cfg.tp_overlap != "off":
        overrides["tp_overlap"] = cfg.tp_overlap
    mixed = (mixed_step or cfg.mixed_step or "off").lower()
    if mixed != "off":
        overrides["mixed_step"] = mixed
    return EngineConfig(hbm_utilization=cfg.hbm_utilization,
                        kv_dtype=resolve_pool_dtype(dtype, kv_dtype, cfg), **overrides)


def build_engine(
    model: str,
    *,
    device: DeviceLike = "cuda",
    max_num_seqs: Optional[int] = None,
    max_model_len: Optional[int] = None,
    dtype: str = "bfloat16",
    kv_dtype: Optional[str] = None,
    prefill_chunk_size: Optional[int] = None,
    enable_prefix_caching: bool = False,
    prefix_host_gb: Optional[float] = None,
    decode_block: Optional[int] = None,
    spec_tokens: Optional[int] = None,
    mixed_step: Optional[str] = None,
    seed: int = 0,
) -> AsyncEngine:
    """An engine on ``device`` under :func:`engine_config`, over a
    ``preset://NAME`` model with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (byte tokenizer), or over the
    HF checkpoint directory ``model`` (its tokenizer). The engine's
    ``core_factory(num_pages)`` builds another core the same way, over
    weights made anew (a worker's fault rebuild); a checkpoint's load ledger
    is on ``engine.load_checksums``."""
    dev = resolve_device(device)
    if dtype not in _DTYPES:
        raise ValueError(f"dtype={dtype!r} (want one of {sorted(_DTYPES)})")
    preset = model.startswith(PRESET_SCHEMES)
    if preset:
        config = get_preset(model.split("://", 1)[1] or "tiny")
    else:
        config = ModelConfig.from_pretrained(Path(model))
    ecfg = engine_config(
        config, dtype=dtype, max_num_seqs=max_num_seqs, max_model_len=max_model_len,
        kv_dtype=kv_dtype, prefill_chunk_size=prefill_chunk_size,
        enable_prefix_caching=enable_prefix_caching, prefix_host_gb=prefix_host_gb,
        decode_block=decode_block, spec_tokens=spec_tokens, mixed_step=mixed_step,
    )
    compute, quantize = _DTYPES[dtype]
    tokenizer = ByteTokenizer() if preset else HFTokenizer(model)
    # The checkpoint's load ledger (the integrity plane's provenance record,
    # as the JAX worker keeps it: tpu_worker.py:380-396).
    ledger: Optional[dict] = None if preset else {}

    def make_core(num_pages: Optional[int] = None) -> EngineCore:
        """A core with weights made anew from their source (the seed, or the
        checkpoint read again): the fault rebuild's trusted copy."""
        if preset:
            generator = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(config, generator, compute, device=dev, quantize=quantize)
        else:
            params = load_checkpoint(model, config, dtype=compute, device=dev, quantize=quantize,
                                     checksum_ledger=ledger)
        cfg = ecfg if num_pages is None else dataclasses.replace(ecfg, num_pages=num_pages)
        return EngineCore(config, params, tokenizer, engine_config=cfg, device=dev)

    engine = AsyncEngine(make_core())
    engine.core_factory = make_core
    engine.load_checksums = ledger
    return engine


def run_torch_worker(
    model: str,
    queue: str,
    *,
    device: DeviceLike = "cuda",
    max_num_seqs: Optional[int] = None,
    max_model_len: Optional[int] = None,
    dtype: str = "bfloat16",
    kv_dtype: Optional[str] = None,
    prefill_chunk_size: Optional[int] = None,
    enable_prefix_caching: bool = False,
    prefix_host_gb: Optional[float] = None,
    decode_block: Optional[int] = None,
    spec_tokens: Optional[int] = None,
    mixed_step: Optional[str] = None,
    role: Optional[str] = None,
    broker_url: Optional[str] = None,
    concurrency: Optional[int] = None,
    max_jobs: Optional[int] = None,
    seed: int = 0,
) -> TorchWorker:
    """Serve ``queue`` from ``broker_url`` (default: ``Config.broker_url``)
    with a preset or checkpoint model; returns the worker (its engine shut
    down) once ``max_jobs`` jobs are settled or a SIGINT / SIGTERM has
    stopped it. ``prefill_chunk_size`` and ``enable_prefix_caching``
    select chunked prefill and the prefix cache, ``prefix_host_gb`` its
    host tier, ``decode_block``, ``spec_tokens`` and ``mixed_step`` the
    fused dispatch modes, ``role`` the disaggregated role, as ``llmq_tpu``'s
    ``run_tpu_worker`` does."""
    config = get_config()
    if role is not None:
        config.worker_role = role
    worker_role(config)  # an unknown role is refused before any weight is loaded
    engine = build_engine(
        model, device=device, max_num_seqs=max_num_seqs, max_model_len=max_model_len,
        dtype=dtype, kv_dtype=kv_dtype, prefill_chunk_size=prefill_chunk_size,
        enable_prefix_caching=enable_prefix_caching, prefix_host_gb=prefix_host_gb,
        decode_block=decode_block, spec_tokens=spec_tokens, mixed_step=mixed_step, seed=seed,
    )
    worker = TorchWorker(queue, engine, broker_url=broker_url, concurrency=concurrency,
                         max_jobs=max_jobs, config=config)
    logger.info("torch worker: model=%s queue=%s device=%s role=%s", model, queue,
                engine.core.device, worker.role)
    try:
        asyncio.run(worker.run())
    except KeyboardInterrupt:
        pass
    finally:
        engine.shutdown()
    return worker


def run_dummy_worker(queue: str, *, concurrency: Optional[int] = None,
                     delay: float = 1.0) -> None:
    setup_logging(structured=True)
    from llmq_tpu_torch.workers.dummy import DummyWorker

    print(f"Starting dummy worker on queue '{queue}'", file=sys.stderr, flush=True)
    _run(DummyWorker(queue, delay=delay, concurrency=concurrency))


def run_dedup_worker(
    queue: str,
    *,
    batch_size: int = 256,
    mode: str = "dedup",
    threshold: float = 0.9,
    embedding: str = "lexical",
    model: Optional[str] = None,
    concurrency: Optional[int] = None,
) -> None:
    setup_logging(structured=True)
    from llmq_tpu_torch.workers.dedup import DedupWorker

    print(f"Starting dedup worker ({mode}, {embedding}) on queue '{queue}'", file=sys.stderr,
          flush=True)
    _run(DedupWorker(queue, batch_size=batch_size, mode=mode, threshold=threshold,
                     embedding=embedding, model=model, concurrency=concurrency))


def _refuse(message: str) -> None:
    print(message, file=sys.stderr, flush=True)
    raise SystemExit(1)


def run_pipeline_worker(config_path: str, stage: str, *, concurrency: Optional[int] = None,
                        device: DeviceLike = "cuda") -> None:
    """Serve one stage of a pipeline file with the worker its type names,
    wired to route its results to the next stage, until a SIGINT /
    SIGTERM stops it (the reference's ``run_pipeline_worker`` :130-180);
    exits 1, as the reference does, for an unknown stage or worker type,
    or a ``tpu`` stage without a model."""
    setup_logging(structured=True)
    pipeline = load_pipeline_config(config_path)
    stage_cfg = pipeline.get_stage_by_name(stage)
    if stage_cfg is None:
        _refuse(f"Stage '{stage}' not in pipeline '{pipeline.name}' "
                f"(stages: {[s.name for s in pipeline.stages]})")
    queue = pipeline.get_stage_queue_name(stage)
    common = dict(pipeline=pipeline, stage_name=stage, concurrency=concurrency)
    if stage_cfg.worker in ("tpu", "vllm"):  # reference files may name vllm
        model = stage_cfg.config.get("model")
        if not model:
            _refuse(f"Stage '{stage}' needs config.model")
        config = get_config()
        worker_role(config)
        engine = build_engine(model, device=device,
                              max_model_len=stage_cfg.config.get("max_model_len"),
                              max_num_seqs=stage_cfg.config.get("max_num_seqs"))
        worker: BaseWorker = TorchWorker(queue, engine, config=config, **common)
    elif stage_cfg.worker == "dummy":
        from llmq_tpu_torch.workers.dummy import DummyWorker

        worker = DummyWorker(queue, delay=float(stage_cfg.config.get("delay", 1.0)), **common)
    elif stage_cfg.worker in ("dedup", "semhash"):
        from llmq_tpu_torch.workers.dedup import DedupWorker

        worker = DedupWorker(
            queue,
            batch_size=int(stage_cfg.config.get("batch_size", 256)),
            mode=stage_cfg.config.get("mode", "dedup"),
            threshold=float(stage_cfg.config.get("threshold", 0.9)),
            embedding=stage_cfg.config.get("embedding", "lexical"),
            model=stage_cfg.config.get("model"),
            **common,
        )
    else:
        _refuse(f"Unknown worker type '{stage_cfg.worker}'")
    print(f"Starting {stage_cfg.worker} worker for stage '{stage}' of pipeline "
          f"'{pipeline.name}'", file=sys.stderr, flush=True)
    _run(worker)


def _run(worker: BaseWorker) -> None:
    try:
        asyncio.run(worker.run())
    except KeyboardInterrupt:
        pass
    finally:
        if isinstance(worker, TorchWorker):
            worker.engine.shutdown()
