"""Device milliseconds per frame of every operation that is not a
__global__ of the program's csrc/ (torch's own kernels, copies and
sets), from the traced window."""

from benchmark import devtrace


def read(data):
    prof = data.get("profile")
    if prof is None or prof["unit"] != "frame":
        return None
    own = devtrace.name_matcher(data["own_kernels"])
    s = sum(v for k, v in prof["device_s_by_name"].items()
            if not own.search(k))
    return s / prof["units"] * 1e3
