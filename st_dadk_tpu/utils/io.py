"""Result persistence: JSON (ref train_st_interp.py:964-986 save_results)
and column CSVs."""
from __future__ import annotations

import csv
import json
import math
from pathlib import Path
from typing import Any, Dict, Sequence

import numpy as np


def json_safe(obj: Any) -> Any:
    """Recursively convert numpy/jax values to JSON-serializable types."""
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if type(obj).__module__.startswith("jax"):
        return json_safe(np.asarray(obj))
    if isinstance(obj, Path):
        return str(obj)
    return obj


def save_json(obj: Any, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(json_safe(obj), f, indent=2)


def write_csv(path: str | Path, columns: Dict[str, Sequence[Any]]) -> None:
    """Write equal-length columns as a CSV with a header row (the layout
    pandas' `DataFrame(columns).to_csv(index=False)` gives: floats by repr,
    NaN as an empty field)."""
    names = list(columns)
    n = len(columns[names[0]]) if names else 0

    def cell(v):
        v = json_safe(v)
        if isinstance(v, float) and math.isnan(v):
            return ""
        return v

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for i in range(n):
            w.writerow([cell(columns[c][i]) for c in names])
