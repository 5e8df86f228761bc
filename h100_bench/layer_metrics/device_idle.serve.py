"""The device's idle share of the traced window of the serving loop, in
%: 1 - (union of the device operations' intervals) / (window length)."""


def read(run):
    t = run.get("trace")
    if run["driver"] != "stream" or not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
