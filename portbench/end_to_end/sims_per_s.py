"""Simulations completed a second: batch x whole rollouts over the time
from the window's start to the last completion."""


def read(w):
    if w["mode"] != "rollout":
        return None
    return w["batch"] * len(w["durations_s"]) / w["window_s"]
