"""Host milliseconds from the call of the program's graphed frame to its
return (copy-in, replay launch, clones), the benchmark's own span, mean
over the measured window."""


def read(data):
    return data.get("host_ms") if data.get("unit") == "frame" else None
