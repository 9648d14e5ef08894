"""Metric catalogue generation: instruments._SPECS -> observability.md.

Counterpart of ``mxnet_tpu/telemetry/catalog.py``.  Every metric family
is declared once (in ``telemetry/instruments.py``) and the docs table is
generated from the declarations.  The port declares the JAX package's
catalogue unchanged, so the table between the two marker comments of
``docs/observability.md`` (written by the JAX package's
``tools/gen_metric_docs.py``) is the port's too, and
:func:`docs_in_sync` holds the port's declarations against it.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

from . import instruments as _ins

__all__ = ["BEGIN_MARK", "END_MARK", "table_markdown", "render_block",
           "apply_block", "docs_in_sync"]

BEGIN_MARK = ("<!-- metric-catalog:begin — generated from "
              "telemetry/instruments.py by "
              "`python tools/gen_metric_docs.py --write`; "
              "do not edit by hand -->")
END_MARK = "<!-- metric-catalog:end -->"

_WS = re.compile(r"\s+")


def _cell(text: str) -> str:
    return _WS.sub(" ", text).replace("|", "\\|").strip()


def table_markdown() -> str:
    """The metric table, one row per declared family, sorted by name."""
    rows = ["| metric | type | labels | meaning |",
            "|---|---|---|---|"]
    sp = _ins.specs()
    for name in sorted(sp):
        s = sp[name]
        labels = ", ".join(f"`{ln}`" for ln in s.labels) or "—"
        rows.append(f"| `{s.name}` | {s.kind} | {labels} "
                    f"| {_cell(s.help)} |")
    return "\n".join(rows)


def render_block() -> str:
    return f"{BEGIN_MARK}\n\n{table_markdown()}\n\n{END_MARK}"


def _default_path() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "docs", "observability.md")


def apply_block(path: Optional[str] = None) -> Tuple[bool, str]:
    """(in_sync, new_text) for the docs file; the file is only read
    (the JAX package's generator writes it).  Raises ValueError when the
    marker pair is missing/garbled — a deleted marker IS drift."""
    p = path or _default_path()
    with open(p, "r", encoding="utf-8") as f:
        text = f.read()
    b = text.find(BEGIN_MARK)
    e = text.find(END_MARK)
    if b < 0 or e < 0 or e < b:
        raise ValueError(
            f"{p}: metric-catalog markers missing or out of order — "
            f"restore them (see telemetry/catalog.py) and regenerate")
    new = text[:b] + render_block() + text[e + len(END_MARK):]
    return new == text, new


def docs_in_sync(path: Optional[str] = None) -> bool:
    ok, _ = apply_block(path)
    return ok
