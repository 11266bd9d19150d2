"""``{var}`` template resolution for ``Job.get_formatted_prompt``.

The part of ``llmq_tpu/core/template.py`` the worker path needs: literal
braces escape as ``{{``/``}}``, unknown placeholders stay verbatim (or
raise with ``strict=True``), and substitution is single-pass, so values
containing braces are safe.
"""

from __future__ import annotations

import string
from typing import Any, Dict, List

_FORMATTER = string.Formatter()


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
