"""Per cent of the traced window (first step span's start to the last
one's end) in which no operation ran on the device."""


def read(data):
    prof = data.get("profile")
    if prof is None or prof["unit"] != "step" or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
