"""Device milliseconds a score pass in the per-Gaussian reductions (the
span reduce of ops/stats.rasterize_stats and of the score view: the
fetch counts, the argmax stream's sort and kernel 7, the score), from
the program's window report of the traced passes (data["program"]:
utils/profiling.window_report over the view replays it matched), scaled
from a view to the pass's views."""


def read(data):
    rep = data.get("program")
    if not rep or data.get("kind") != "score":
        return None
    secs, replays = 0.0, 0
    for g in rep["graphs"].values():
        replays += g["replays"] - g["unmatched"]
        secs += sum(s for label, s in g["stage_s"].items()
                    if label.split("/")[-1] == "reduce")
    if replays <= 0 or secs <= 0:
        return None
    return secs / replays * data["views"] * 1e3
