"""Device milliseconds of a pass's densify event (train/scratch.
densify_event, in its spans densify/grow, densify/clone, densify/split,
densify/prune and densify/reset), from the program's window report of
the traced pass (data["program"]: utils/profiling.window_report over a
window of one pass; the event runs outside every graph, so its
operations count under outside_s by the span they were launched in)."""


def read(data):
    rep = data.get("program")
    if not rep or data.get("kind") != "scratch":
        return None
    secs = sum(s for label, s in rep["outside_s"].items()
               if label.startswith("densify/"))
    return secs * 1e3 if secs > 0 else None
