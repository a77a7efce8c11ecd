"""The table of peaks the per-layer readers hold device times
against."""

from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def peak(kind: str, what: str) -> float:
    with open(PEAKS) as f:
        table = json.load(f)
    return float(table.get(kind, table["NVIDIA H100 80GB HBM3"])[what])
