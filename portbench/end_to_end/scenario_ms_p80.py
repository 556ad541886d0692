"""The 80th percentile of the rollouts' times in the window, in ms: from
the call to ``rollout`` until its predictions are on the device."""
import statistics


def read(w):
    if w["mode"] != "rollout" or len(w["durations_s"]) < 2:
        return None
    return 1e3 * statistics.quantiles(w["durations_s"], n=5)[3]
