"""Multi-stage pipeline schema (port of ``llmq_tpu/core/pipeline.py``).

A pipeline is an ordered list of named stages, each bound to a worker type
and a per-stage config; each stage gets the queue
``pipeline.<name>.<stage>`` and the pipeline has one final
``pipeline.<name>.results`` queue. Every stage's ``config.prompt`` /
``config.messages`` template is applied at hand-off, with the previous
stage's output exposed as ``{result}`` (plus every passthrough extra):
``broker/manager.py::BrokerManager.build_next_stage_job``.

The file is YAML. PyYAML is imported when a file is read; where it is
not installed, the text is read as JSON (YAML is a superset of JSON, so a
JSON file gives the same dict), and any other text is refused with an
error that names PyYAML.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

from pydantic import BaseModel, ConfigDict, Field, field_validator

_QUEUE_SAFE_RE = re.compile(r"^[A-Za-z0-9_-]+$")


def _validate_queue_safe(value: str, what: str) -> str:
    if not value or not isinstance(value, str) or not _QUEUE_SAFE_RE.match(value):
        raise ValueError(f"{what} can only contain letters, numbers, hyphens, and underscores")
    return value


def _load_text(text: str) -> Any:
    """The document in ``text``: PyYAML's ``safe_load``, or JSON without
    PyYAML."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except json.JSONDecodeError as exc:
            raise ValueError(
                "Pipeline configuration is not JSON, and reading YAML needs PyYAML, which is "
                f"not installed ({exc})") from exc
    return yaml.safe_load(text)


class PipelineStage(BaseModel):
    """One stage: a worker type plus stage-specific config."""

    name: str = Field(description="Stage name (unique within the pipeline)")
    worker: str = Field(description="Worker type: 'tpu', 'dummy', 'dedup', ...")
    config: Dict[str, Any] = Field(default_factory=dict)

    model_config = ConfigDict(extra="forbid")

    @field_validator("name")
    @classmethod
    def _name_queue_safe(cls, v: str) -> str:
        return _validate_queue_safe(v, "Stage name")

    def prompt_template(self) -> Optional[str]:
        return self.config.get("prompt")

    def messages_template(self) -> Optional[List[Dict[str, Any]]]:
        return self.config.get("messages")


class PipelineConfig(BaseModel):
    """Ordered stages + global config."""

    name: str
    stages: List[PipelineStage] = Field(min_length=1)
    config: Dict[str, Any] = Field(default_factory=dict)

    model_config = ConfigDict(extra="forbid")

    @field_validator("name")
    @classmethod
    def _name_queue_safe(cls, v: str) -> str:
        return _validate_queue_safe(v, "Pipeline name")

    @field_validator("stages")
    @classmethod
    def _unique_stage_names(cls, v: List[PipelineStage]) -> List[PipelineStage]:
        names = [s.name for s in v]
        if len(names) != len(set(names)):
            raise ValueError("All stage names must be unique within a pipeline")
        return v

    # --- queue topology ---------------------------------------------------
    def get_stage_queue_name(self, stage_name: str) -> str:
        return f"pipeline.{self.name}.{stage_name}"

    def get_pipeline_results_queue_name(self) -> str:
        return f"pipeline.{self.name}.results"

    def stage_queue_names(self) -> List[str]:
        return [self.get_stage_queue_name(s.name) for s in self.stages]

    def get_stage_by_name(self, stage_name: str) -> Optional[PipelineStage]:
        for stage in self.stages:
            if stage.name == stage_name:
                return stage
        return None

    def next_stage(self, stage_name: str) -> Optional[PipelineStage]:
        """Stage after ``stage_name``, or None if it is the last."""
        for i, stage in enumerate(self.stages):
            if stage.name == stage_name:
                return self.stages[i + 1] if i + 1 < len(self.stages) else None
        raise KeyError(f"Unknown stage: {stage_name!r}")

    # --- loading ----------------------------------------------------------
    @classmethod
    def from_yaml_file(cls, path: Path | str) -> "PipelineConfig":
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(f"Pipeline configuration file not found: {path}")
        return cls.from_yaml_string(path.read_text())

    @classmethod
    def from_yaml_string(cls, yaml_str: str) -> "PipelineConfig":
        data = _load_text(yaml_str)
        if not isinstance(data, dict):
            raise ValueError("Pipeline configuration must be a YAML object")
        return cls(**data)

    def to_dict(self) -> Dict[str, Any]:
        return self.model_dump()


def load_pipeline_config(path: Path | str) -> PipelineConfig:
    return PipelineConfig.from_yaml_file(path)
