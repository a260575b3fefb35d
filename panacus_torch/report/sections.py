"""Report sections: the JSON-serializable unit of analysis output.

The port's copy of panacus_tpu/report/sections.py.

Schema-compatible with the reference's serde output so `report --json` dumps
can be merged and rendered later by `render`
(reference: src/html_report.rs:56-66, 395-457). ReportItems are kept as
externally-tagged dicts ({"Bar": {...}}) exactly like serde's enum encoding.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def default_plot_downloads() -> List[Tuple[str, str]]:
    return [
        ("png", "Download as png"),
        ("svg", "Download as svg"),
        ("vega-editor", "Open in vega editor"),
    ]


@dataclass
class AnalysisSection:
    analysis: str
    run_name: str
    run_id: str
    countable: str
    items: List[Dict[str, Any]]  # externally-tagged ReportItems
    id: str
    table: Optional[str] = None
    plot_downloads: List[Tuple[str, str]] = field(
        default_factory=default_plot_downloads
    )

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "analysis": self.analysis,
            "run_name": self.run_name,
            "run_id": self.run_id,
            "countable": self.countable,
            "items": self.items,
            "id": self.id,
            "table": self.table,
            "plot_downloads": [list(t) for t in self.plot_downloads],
        }

    @classmethod
    def from_json_dict(cls, d: Dict[str, Any]) -> "AnalysisSection":
        return cls(
            analysis=d["analysis"],
            run_name=d["run_name"],
            run_id=d["run_id"],
            countable=d["countable"],
            items=d["items"],
            id=d["id"],
            table=d.get("table"),
            plot_downloads=[tuple(t) for t in d.get("plot_downloads", [])],
        )


def bar(id, name, x_label, y_label, labels, values, log_toggle) -> Dict[str, Any]:
    return {
        "Bar": {
            "id": id,
            "name": name,
            "x_label": x_label,
            "y_label": y_label,
            "labels": labels,
            "values": values,
            "log_toggle": log_toggle,
        }
    }


def multi_bar(
    id, names, x_label, y_label, labels, values, log_toggle
) -> Dict[str, Any]:
    return {
        "MultiBar": {
            "id": id,
            "names": names,
            "x_label": x_label,
            "y_label": y_label,
            "labels": labels,
            "values": values,
            "log_toggle": log_toggle,
        }
    }


def table_item(id, header, values) -> Dict[str, Any]:
    return {"Table": {"id": id, "header": header, "values": values}}


def heatmap(id, name, x_labels, y_labels, values) -> Dict[str, Any]:
    return {
        "Heatmap": {
            "id": id,
            "name": name,
            "x_labels": x_labels,
            "y_labels": y_labels,
            "values": values,
        }
    }


def hexbin_item(id, bins) -> Dict[str, Any]:
    return {"Hexbin": {"id": id, "bins": bins}}


def line(
    id, name, x_label, y_label, x_values, y_values, log_x, log_y
) -> Dict[str, Any]:
    return {
        "Line": {
            "id": id,
            "name": name,
            "x_label": x_label,
            "y_label": y_label,
            "x_values": x_values,
            "y_values": y_values,
            "log_x": log_x,
            "log_y": log_y,
        }
    }
