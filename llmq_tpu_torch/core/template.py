"""Templating: ``{var}`` resolution and ``--map`` specs (port of
``llmq_tpu/core/template.py``), used by ``Job.get_formatted_prompt``,
``submit`` and the pipelines' stage hand-off.

Template forms (the reference's ``--map`` semantics):

1. JSON template: a ``--map`` value that parses as JSON (string-with-vars,
   messages list, or object) — placeholders resolved recursively.
2. String template: ``"Translate {text} to {lang}"`` — ``{var}`` placeholders
   resolved from the data row; literal braces escaped as ``{{``/``}}``.
3. Plain column copy: a bare column name copies that column's value.

Unknown placeholders stay verbatim (or raise with ``strict=True``), and
substitution is single-pass, so values containing braces are safe.
"""

from __future__ import annotations

import json
import re
import string
import uuid
from typing import Any, Dict, List, Optional

_FORMATTER = string.Formatter()
_VAR_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def extract_template_variables(template: str) -> List[str]:
    """Field names referenced by ``{var}`` placeholders (ignores ``{{``)."""
    out: List[str] = []
    for _, field, _, _ in _FORMATTER.parse(template):
        if field:
            root = field.split(".")[0].split("[")[0]
            if root and root not in out:
                out.append(root)
    return out


class _SafeDict(dict):
    """Leaves unknown placeholders intact instead of raising."""

    def __missing__(self, key: str) -> str:
        return "{" + key + "}"


def resolve_template_string(
    template: str, data: Dict[str, Any], *, strict: bool = False
) -> str:
    """Resolve ``{var}`` placeholders in ``template`` from ``data``."""
    if strict:
        missing = [v for v in extract_template_variables(template) if v not in data]
        if missing:
            raise KeyError(f"Missing template variables: {missing}")
    return _FORMATTER.vformat(template, (), _SafeDict(data))


def resolve_template_value(value: Any, data: Dict[str, Any]) -> Any:
    """Recursively resolve placeholders inside strings/lists/dicts."""
    if isinstance(value, str):
        return resolve_template_string(value, data)
    if isinstance(value, list):
        return [resolve_template_value(v, data) for v in value]
    if isinstance(value, dict):
        return {k: resolve_template_value(v, data) for k, v in value.items()}
    return value


def parse_map_spec(raw: str) -> Any:
    """Parse one ``--map field=SPEC`` value: JSON if it parses, else string."""
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, TypeError):
        return raw


def apply_mapping(mapping: Dict[str, Any], row: Dict[str, Any]) -> Dict[str, Any]:
    """Apply ``--map``-style field specs to one data row. For each
    ``field -> spec``: a list or dict resolves its placeholders
    recursively; a string with ``{var}`` placeholders is a string
    template; a bare identifier naming a column of the row copies it;
    anything else is a literal."""
    out: Dict[str, Any] = {}
    for field, spec in mapping.items():
        if isinstance(spec, (list, dict)):
            out[field] = resolve_template_value(spec, row)
        elif isinstance(spec, str):
            if extract_template_variables(spec):
                out[field] = resolve_template_string(spec, row)
            elif _VAR_RE.match(spec) and spec in row:
                out[field] = row[spec]
            else:
                out[field] = spec
        else:
            out[field] = spec
    return out


def create_job_from_row(
    row: Dict[str, Any],
    mapping: Optional[Dict[str, Any]] = None,
    *,
    job_id: Optional[str] = None,
) -> Dict[str, Any]:
    """A Job-shaped dict from a data row and an optional ``--map``:

    1. a row with ``prompt`` or ``messages`` is used as-is (templates in
       ``prompt`` resolve at the worker from the extras);
    2. a mapping's ``prompt`` / ``messages`` is applied against the row;
    3. else the ``text`` column becomes the prompt verbatim.

    Every column rides along as an extra field, for passthrough and
    templating; the row's ``id`` wins over ``job_id``.
    """
    data: Dict[str, Any] = dict(row)
    if mapping:
        data.update(apply_mapping(mapping, row))
    if "prompt" not in data and "messages" not in data:
        if "text" in row:
            data["prompt"] = str(row["text"])
        else:
            raise ValueError(
                "Row has no 'prompt'/'messages' and no 'text' "
                f"column to fall back on; use --map. Columns: {sorted(row)}"
            )
    if "prompt" in data and "messages" in data:
        # The field the mapping set explicitly wins; else the prompt.
        if mapping and "prompt" in mapping:
            data.pop("messages", None)
        elif mapping and "messages" in mapping:
            data.pop("prompt", None)
        else:
            data.pop("messages", None)
    data.setdefault("id", job_id or uuid.uuid4().hex)
    return data
