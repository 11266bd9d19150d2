"""Pipelines, templates and the dedup worker of the port, held against the
JAX package on the same inputs.

- Pipeline files: ``core/pipeline.py`` loads the same strings as the
  reference (``example-pipeline.yaml``, a JSON copy of it, a messages
  stage) into the same ``to_dict()``, queue names and ``next_stage``, and
  refuses the same bad ones with the same errors; without PyYAML it reads
  the JSON copy and refuses YAML naming PyYAML.
- Templates: ``apply_mapping`` / ``create_job_from_row`` give equal job
  dicts for the same rows and ``--map`` specs.
- The stage hand-off: ``BrokerManager.build_next_stage_job`` builds equal
  next-stage payloads from the same ``Result`` (prompt template, messages
  template, no template).
- Dedup: equal keep masks in every mode over lexical and model
  embeddings (the ``tests/make_hf_fixture.py`` checkpoint's table), and
  equal results from a ``DedupWorker`` of each package.
- End to end: the ``example-pipeline.yaml`` shape (two ``tpu`` stages,
  the fixture checkpoint at each, f32) through the port's
  ``run_pipeline_submit``, two ``TorchWorker`` stage workers and
  ``run_pipeline_receive`` over ``memory://`` prints the same final
  results as the reference's functions and two ``TPUWorker`` stage
  workers (sharing one JAX engine): ids, texts, greedy token ids and
  passthrough fields.
"""

import asyncio
import json
import os
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest
import yaml

from llmq_tpu_torch.broker.manager import BrokerManager
from llmq_tpu_torch.core import pipeline as port_pipeline
from llmq_tpu_torch.core import template as port_template
from llmq_tpu_torch.core.models import Result
from llmq_tpu_torch.workers import dedup as port_dedup

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = (ROOT / "example-pipeline.yaml").read_text()

MESSAGES_PIPELINE = """
name: chat_2
config: {owner: ops}
stages:
  - name: draft
    worker: dummy
    config: {delay: 0}
  - name: review
    worker: tpu
    config:
      model: some/model
      messages:
        - {role: system, content: "Review {lang} text."}
        - {role: user, content: "{result} (was: {prompt})"}
  - name: last
    worker: dedup
"""

BAD_PIPELINES = [
    "name: bad name\nstages: [{name: a, worker: dummy}]",
    "name: p\nstages: [{name: a, worker: dummy}, {name: a, worker: tpu}]",
    "name: p\nstages: []",
    "name: p\nstages: [{name: 'a.b', worker: dummy}]",
    "name: p\nstages: [{name: a, worker: dummy, extra: 1}]",
    "name: p\nstages: [{name: a, worker: dummy}]\nunknown: 1",
    "- just\n- a list",
    "name: p",
]


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as exc:  # noqa: BLE001 — the refusal is the result
        return type(exc).__name__, str(exc)


def _describe(cfg):
    return dict(
        to_dict=cfg.to_dict(), stage_queues=cfg.stage_queue_names(),
        results=cfg.get_pipeline_results_queue_name(),
        next={s.name: getattr(cfg.next_stage(s.name), "name", None) for s in cfg.stages},
        templates={s.name: (s.prompt_template(), s.messages_template()) for s in cfg.stages},
        unknown=_outcome(lambda: cfg.next_stage("nope")),
        by_name=cfg.get_stage_by_name("nope"),
    )


@pytest.mark.parametrize("text", [EXAMPLE, json.dumps(yaml.safe_load(EXAMPLE)),
                                  MESSAGES_PIPELINE, *BAD_PIPELINES],
                         ids=["example", "example-json", "messages"] +
                             [f"bad{i}" for i in range(len(BAD_PIPELINES))])
def test_pipeline_configs_load_as_the_reference(text):
    from llmq_tpu.core import pipeline as ref

    want = _outcome(lambda: _describe(ref.PipelineConfig.from_yaml_string(text)))
    got = _outcome(lambda: _describe(port_pipeline.PipelineConfig.from_yaml_string(text)))
    assert got == want


def test_pipeline_files_load_as_the_reference_and_without_pyyaml(tmp_path, monkeypatch):
    from llmq_tpu.core import pipeline as ref

    path = tmp_path / "p.yaml"
    path.write_text(EXAMPLE)
    assert (port_pipeline.load_pipeline_config(path).to_dict()
            == ref.load_pipeline_config(path).to_dict())
    missing = tmp_path / "none.yaml"
    assert (_outcome(lambda: port_pipeline.load_pipeline_config(missing))
            == _outcome(lambda: ref.load_pipeline_config(missing)))
    # No PyYAML: a JSON file gives the same config, YAML is refused by name.
    json_copy = json.dumps(ref.PipelineConfig.from_yaml_string(EXAMPLE).to_dict())
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert (port_pipeline.PipelineConfig.from_yaml_string(json_copy).to_dict()
            == ref.load_pipeline_config(path).to_dict())
    with pytest.raises(ValueError, match="PyYAML"):
        port_pipeline.PipelineConfig.from_yaml_string(EXAMPLE)


# --- templates ------------------------------------------------------------------

ROWS = [
    {"text": "Hello {world}", "lang": "de", "n": 3},
    {"id": "given", "prompt": "Say {lang}", "lang": "fr", "messages": [{"role": "user",
                                                                        "content": "x"}]},
    {"messages": [{"role": "user", "content": "hi"}], "topic": "cats"},
    {"title": "T", "body": "B", "nested": {"a": 1}},
    {"question": "2+2?", "text": "ignored"},
]
MAPS = [
    None,
    {"prompt": "Translate {text} to {lang}", "lang": "en"},
    {"messages": [{"role": "user", "content": "About {topic}: {missing}"}]},
    {"prompt": "question", "tag": "literal value", "n": 7},
    {"prompt": "{{literal}} {title} / {body}", "meta": {"k": "{title}", "l": ["{body}", 1]}},
    {"messages": "plain string spec"},
]
SPECS = ['{"role": "user"}', "[1, 2", "Translate {text}", "42", "null", "text"]


@pytest.mark.parametrize("mapping", MAPS, ids=[f"map{i}" for i in range(len(MAPS))])
def test_templates_build_the_reference_job_dicts(mapping):
    from llmq_tpu.core import template as ref

    for i, row in enumerate(ROWS):
        args = (row, mapping)
        assert (_outcome(lambda: port_template.create_job_from_row(*args, job_id=f"j{i}"))
                == _outcome(lambda: ref.create_job_from_row(*args, job_id=f"j{i}")))
        if mapping:
            assert (port_template.apply_mapping(mapping, row)
                    == ref.apply_mapping(mapping, row))
    for spec in SPECS:
        assert port_template.parse_map_spec(spec) == ref.parse_map_spec(spec)


# --- the stage hand-off ---------------------------------------------------------

RESULT = dict(id="job-7", prompt="Translate: Hallo {x}", result="Hello {world} }{ done",
              worker_id="w-1", duration_ms=12.5, usage={"prompt_tokens": 9,
                                                        "completion_tokens": 4},
              token_ids=[5, 6, 7, 8], token_digest="abc", finish_reason="length",
              text="Hallo", lang="de", row=7, temperature=0.0, max_tokens=6)


@pytest.mark.parametrize("stage_cfg", [
    {"prompt": "Format as markdown:\n\n{result} [{lang}] {missing}"},
    {"messages": [{"role": "system", "content": "Row {row} from {prompt}"},
                  {"role": "user", "content": "{result}"}]},
    {},
], ids=["prompt", "messages", "no-template"])
@pytest.mark.parametrize("previous", [None, "the first stage's text"])
def test_next_stage_job_is_the_reference_payload(stage_cfg, previous):
    from llmq_tpu.broker.manager import BrokerManager as RefManager
    from llmq_tpu.core.models import Result as RefResult
    from llmq_tpu.core.pipeline import PipelineStage as RefStage

    fields = dict(RESULT, **({} if previous is None else {"previous_result": previous}))
    want = RefManager.build_next_stage_job(RefResult(**fields),
                                           RefStage(name="next", worker="tpu", config=stage_cfg))
    got = BrokerManager.build_next_stage_job(
        Result(**fields), port_pipeline.PipelineStage(name="next", worker="tpu",
                                                      config=stage_cfg))
    assert got.model_dump() == want.model_dump()
    assert got.extras() == want.extras()


@pytest.mark.parametrize("output", ["a lone { brace", "a {prompt} placeholder", "{{escaped}}"])
def test_stage_output_is_templated_again_at_the_worker_as_the_reference(output):
    """The next stage's prompt holds the previous output verbatim, and the
    worker resolves ``{var}`` in it once more (``Job.get_formatted_prompt``):
    a placeholder in a model's output takes an extra's value, a lone brace
    raises ``ValueError`` (the worker drops such a job). Both packages do
    so (ROADMAP.md queue 3, open in the reference)."""
    from llmq_tpu.broker.manager import BrokerManager as RefManager
    from llmq_tpu.core.models import Result as RefResult
    from llmq_tpu.core.pipeline import PipelineStage as RefStage

    fields = dict(RESULT, result=output)
    stage = {"prompt": "Format:\n\n{result}"}
    want = RefManager.build_next_stage_job(RefResult(**fields),
                                           RefStage(name="n", worker="tpu", config=stage))
    got = BrokerManager.build_next_stage_job(
        Result(**fields), port_pipeline.PipelineStage(name="n", worker="tpu", config=stage))
    assert got.prompt == want.prompt == "Format:\n\n" + output
    assert _outcome(got.get_formatted_prompt) == _outcome(want.get_formatted_prompt)


# --- dedup ------------------------------------------------------------------------

TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "The quick brown fox jumps over the lazy dog!",
    "Message queues decouple producers from consumers.",
    "message queues decouple producers from consumers",
    "Continuous batching keeps the accelerator busy.",
    "Paged attention stores the KV cache in fixed-size blocks.",
    "Tensor processing units excel at dense linear algebra.",
    "Translate the following sentence into German.",
    "ab",
    "",
]
MODES = [("dedup", 0.9), ("dedup", 0.5), ("outliers", 0.8), ("representative", 0.6),
         ("representative", 0.95)]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from tests.make_hf_fixture import build

    # The fixture builds a PyTorch model; without USE_TF=0 transformers
    # also imports TensorFlow where it is installed (~8 s on one core).
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        pytest.importorskip("transformers")
        return build(tmp_path_factory.mktemp("hf") / "qwen2-micro")


def test_dedup_keep_masks_equal_the_reference(hf_dir):
    from llmq_tpu.workers import dedup as ref

    lexical = port_dedup.embed(TEXTS)
    np.testing.assert_array_equal(lexical, ref.embed(TEXTS))
    model = port_dedup.ModelEmbedder.from_checkpoint(str(hf_dir))(TEXTS)
    np.testing.assert_array_equal(model, ref.ModelEmbedder.from_checkpoint(str(hf_dir))(TEXTS))
    for vectors in (lexical, model):
        for mode, threshold in MODES:
            np.testing.assert_array_equal(
                port_dedup.select_keep_mask(vectors, mode, threshold),
                ref.select_keep_mask(vectors, mode, threshold))
    assert (_outcome(lambda: port_dedup.select_keep_mask(lexical, "nope", 0.5))
            == _outcome(lambda: ref.select_keep_mask(lexical, "nope", 0.5)))


async def _dedup_results(worker_cls, make_broker, job_cls, url):
    broker = make_broker(url)
    await broker.connect()
    for i, text in enumerate(TEXTS):
        job = job_cls(id=f"d{i}", prompt="{text}", text=text, row=i)
        await broker.publish("dq", job.model_dump_json().encode(), message_id=job.id)
    worker = worker_cls("dq", batch_size=len(TEXTS), mode="dedup", threshold=0.8)
    task = asyncio.create_task(worker.run())
    out = []
    while len(out) < len(TEXTS):
        msg = await broker.get("dq.results")
        if msg is None:
            await asyncio.sleep(0.02)
            continue
        out.append(json.loads(msg.body))
        await msg.ack()
    worker.request_shutdown()
    await asyncio.wait_for(task, 30)
    await broker.close()
    return {r["id"]: (r["result"], r["row"], r["prompt"]) for r in out}


def test_dedup_worker_results_equal_the_reference(monkeypatch):
    from llmq_tpu.broker.base import make_broker as ref_make_broker
    from llmq_tpu.core.models import Job as RefJob
    from llmq_tpu.workers.dedup import DedupWorker as RefDedup

    from llmq_tpu_torch.broker.base import make_broker
    from llmq_tpu_torch.core.models import Job

    url = f"memory://dedup-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("LLMQ_BROKER_URL", url)
    want = asyncio.run(_dedup_results(RefDedup, ref_make_broker, RefJob, url))
    got = asyncio.run(_dedup_results(port_dedup.DedupWorker, make_broker, Job, url))
    assert got == want
    assert sum(r == port_dedup.DROPPED_MARKER for r, _, _ in got.values()) >= 2


# --- end to end: the example pipeline's shape, two stages, f32 ----------------

N_JOBS = 4
GEN = 6
ENGINE = dict(dtype="float32", max_num_seqs=4, max_model_len=128)


def _pipeline_file(tmp_path, hf_dir) -> Path:
    data = yaml.safe_load(EXAMPLE)
    for stage in data["stages"]:
        stage["config"]["model"] = str(hf_dir)
    path = tmp_path / "example-pipeline.yaml"
    path.write_text(yaml.safe_dump(data))
    return path


def _jobs_file(tmp_path) -> Path:
    path = tmp_path / "jobs.jsonl"
    path.write_text("\n".join(json.dumps(dict(
        id=f"row-{i}", text=TEXTS[2 * i], temperature=0.0, max_tokens=GEN, ignore_eos=True,
        row=i, lang="de")) for i in range(N_JOBS)) + "\n")
    return path


async def _run_pipeline(submit, receive, make_broker, workers, path, jobs):
    """Submit, then each stage's worker once its N jobs wait (so each
    stage's engine takes them in one prefill, one compiled shape for the
    JAX engine), then receive the N final results and stop the workers."""
    await submit(str(path), str(jobs), {})
    broker = make_broker(os.environ["LLMQ_BROKER_URL"])
    await broker.connect()
    tasks = []
    try:
        for w in workers:
            for _ in range(1200):
                if ((await broker.stats(w.queue)).message_count_ready or 0) >= N_JOBS:
                    break
                await asyncio.sleep(0.05)
            tasks.append(asyncio.create_task(w.run()))
        await asyncio.wait_for(receive(str(path), limit=N_JOBS, timeout=60), 120)
    finally:
        for w in workers:
            w.request_shutdown()
        await asyncio.gather(*tasks)
        await broker.close()


def _final_results(out: str) -> dict:
    """Printed results by id, without what a run stamps (worker, times);
    the lifecycle ``trace`` without its times and worker ids (event names,
    order and the other fields are compared)."""
    from test_torch_obs import comparable_trace

    results = {}
    for line in out.strip().splitlines():
        r = json.loads(line)
        for key in ("worker_id", "duration_ms", "timestamp"):
            r.pop(key, None)
        r["trace"] = comparable_trace(r["trace"])
        results[r["id"]] = r
    return results


class _SharedEngine:
    """One JAX engine behind both reference stage workers: each worker's
    cleanup leaves it running."""

    def __init__(self, engine):
        object.__setattr__(self, "_engine", engine)

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __setattr__(self, name, value):
        setattr(self._engine, name, value)

    def shutdown(self):
        return None


def test_example_pipeline_gives_the_reference_results(hf_dir, tmp_path, monkeypatch, capsys):
    from llmq_tpu.broker.base import make_broker as ref_make_broker
    from llmq_tpu.cli.receive import run_pipeline_receive as ref_receive
    from llmq_tpu.cli.submit import run_pipeline_submit as ref_submit
    from llmq_tpu.core.pipeline import load_pipeline_config as ref_load
    from llmq_tpu.workers.tpu_worker import TPUWorker

    from llmq_tpu_torch.broker.base import make_broker
    from llmq_tpu_torch.cli.receive import run_pipeline_receive
    from llmq_tpu_torch.cli.submit import run_pipeline_submit
    from llmq_tpu_torch.cli.worker import build_engine
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    path, jobs = _pipeline_file(tmp_path, hf_dir), _jobs_file(tmp_path)
    monkeypatch.setenv("LLMQ_RESULT_DIGEST", "1")

    monkeypatch.setenv("LLMQ_BROKER_URL", f"memory://ref-pipe-{uuid.uuid4().hex[:8]}")
    ref_cfg = ref_load(path)
    engine = TPUWorker("warm", model=str(hf_dir), **ENGINE)._build_engine()
    try:
        shared = _SharedEngine(engine)
        ref_workers = [TPUWorker(ref_cfg.get_stage_queue_name(s.name), model=str(hf_dir),
                                 pipeline=ref_cfg, stage_name=s.name,
                                 engine_factory=lambda w: shared, **ENGINE)
                       for s in ref_cfg.stages]
        asyncio.run(_run_pipeline(ref_submit, ref_receive, ref_make_broker, ref_workers, path,
                                  jobs))
    finally:
        engine.shutdown()
    want = _final_results(capsys.readouterr().out)

    monkeypatch.setenv("LLMQ_BROKER_URL", f"memory://port-pipe-{uuid.uuid4().hex[:8]}")
    cfg = port_pipeline.load_pipeline_config(path)
    engines = [build_engine(str(hf_dir), device="cpu", **ENGINE) for _ in cfg.stages]
    try:
        workers = [TorchWorker(cfg.get_stage_queue_name(s.name), e, pipeline=cfg,
                               stage_name=s.name) for s, e in zip(cfg.stages, engines)]
        asyncio.run(_run_pipeline(run_pipeline_submit, run_pipeline_receive, make_broker,
                                  workers, path, jobs))
    finally:
        for e in engines:
            e.shutdown()
    got = _final_results(capsys.readouterr().out)
    for w in workers:  # each stage worker's stats line: its tokens and busy span
        stats = w.stats()
        assert stats["completion_tokens"] == N_JOBS * GEN and stats["busy_s"] > 0
        assert "kernel_launches" not in stats  # the plain versions ran (CPU tensors)

    assert sorted(got) == [f"row-{i}" for i in range(N_JOBS)]
    assert got == want
    stage = ["submitted", "claimed", "tokenized", "admitted", "prefill_start", "first_token",
             "decode", "finished"]
    assert [e["name"] for e in got["row-0"]["trace"][2]] == stage * 2  # the hand-off
    for r in got.values():
        assert r["usage"]["completion_tokens"] == GEN and len(r["token_ids"]) == GEN
        assert r["prompt"].startswith("Format the following translation as clean markdown")
        assert r["previous_result"] in r["prompt"] and r["lang"] == "de"


def test_held_back_stream_text_is_a_prefix_of_the_result_with_the_hf_tokenizer(hf_dir):
    """Queue 3 item 20 with the fixture's byte-level BPE tokenizer: prompts
    in accented, CJK and emoji text fall back to byte tokens, so characters
    split across tokens. The port's stream (one flush a token) only ever
    sends a prefix of the final text, and its frames join to it."""
    from llmq_tpu_torch.engine.tokenizer import HFTokenizer

    from test_torch_obs import joined, stream_frames

    tok = HFTokenizer(str(hf_dir))
    for text in ("café crème brûlée", "日本語のテキスト", "queue 🙂 ok 🚀", "plain ascii"):
        ids = tok.encode(text)
        final = tok.decode(ids)
        frames = stream_frames("port", tok, ids, final)
        sent = ""
        for frame in frames:
            sent += frame["text"]
            assert final.startswith(sent), (text, sent, final)
        assert joined(frames) == final and frames[-1]["done"]
