"""Custom report sections: embed user-supplied files into the report
(reference: src/html_report.rs:129-206)."""

from __future__ import annotations

import base64
import json as json_mod
import os
from typing import List

from .sections import AnalysisSection


def generate_custom_section(gb, name: str, file: str) -> List[AnalysisSection]:
    ext = os.path.splitext(file)[1].lower().lstrip(".")
    sid = f"custom-{name}".lower().replace(" ", "-")
    if ext == "png":
        with open(file, "rb") as f:
            data = base64.b64encode(f.read()).decode()
        item = {"Png": {"id": sid, "file": data}}
    elif ext == "svg":
        with open(file) as f:
            item = {"Svg": {"id": sid, "file": f.read()}}
    elif ext == "pdf":
        with open(file, "rb") as f:
            data = base64.b64encode(f.read()).decode()
        item = {"Pdf": {"id": sid, "file": data}}
    elif ext == "json":
        with open(file) as f:
            item = {"Json": {"id": sid, "file": f.read()}}
    elif ext in ("csv", "tsv"):
        sep = "," if ext == "csv" else "\t"
        with open(file) as f:
            rows = [line.rstrip("\n").split(sep) for line in f if line.strip()]
        header = rows[0] if rows else []
        values = rows[1:] if len(rows) > 1 else []
        item = {"Table": {"id": sid, "header": header, "values": values}}
    else:
        raise ValueError(f"unsupported custom section file type: {file}")
    return [
        AnalysisSection(
            id=sid,
            analysis="Custom",
            run_name=name,
            run_id=sid,
            countable="custom",
            table=None,
            items=[item],
        )
    ]
