"""Device milliseconds per step of the program's own kernels (the
__global__ functions of its csrc/, names parsed from the sources at run
time), from the traced window."""

from benchmark import devtrace


def read(data):
    prof = data.get("profile")
    if prof is None or prof["unit"] != "step":
        return None
    return devtrace.device_seconds(prof, data["own_kernels"]) \
        / prof["units"] * 1e3
