"""Device milliseconds a frame in the four MM-FR passes' sort stage (the
fused-key sort and the segment bounds, the span pass<l>/sort), from the
program's window report of the traced frames (data["program"]:
utils/profiling.window_report over the graph replays it matched)."""


def read(data):
    rep = data.get("program")
    if not rep or data.get("kind") != "mmfr":
        return None
    secs, frames = 0.0, 0
    for g in rep["graphs"].values():
        frames += g["replays"] - g["unmatched"]
        secs += sum(s for label, s in g["stage_s"].items()
                    if label.startswith("pass") and label.endswith("/sort"))
    if frames <= 0 or secs <= 0:
        return None
    return secs / frames * 1e3
