"""The program's own graph counters, read in the benchmark's process
after the run: utils/profiling.RECORDS of fovsplat_torch, one record per
captured CUDA graph with the device operations a replay launches
(`nodes`), the bytes a call copies into its static inputs (`bytes_in`)
and clones out of its outputs (`bytes_out`), and its replays. A frame
or step of the cells is one call of one graph, so a count a call is a
count a unit of work. A program without the records reads nothing.
"""

from __future__ import annotations

import sys


def per_call(data: dict, unit: str):
    """(device operations, bytes copied in and cloned out) a graph call,
    averaged over every replay of the run's graphs; None unless the run's
    unit is `unit` and the program kept records of replayed graphs."""
    if data.get("unit") != unit:
        return None
    prof = sys.modules.get("fovsplat_torch.utils.profiling")
    records = getattr(prof, "RECORDS", None)
    if not records:
        return None
    recs = list(records.values())
    calls = sum(r.replays for r in recs)
    if calls <= 0:
        return None
    ops = sum(r.nodes * r.replays for r in recs)
    moved = sum((r.bytes_in + r.bytes_out) * r.replays for r in recs)
    return ops / calls, moved / calls
