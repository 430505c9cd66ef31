"""Host milliseconds from the call of the program's graphed train step to
its return, the benchmark's own span, mean over the measured window."""


def read(data):
    return data.get("host_ms") if data.get("unit") == "step" else None
