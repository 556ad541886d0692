"""Training samples consumed a second: batch x train steps completed over
the time from the window's start to the last completion."""


def read(w):
    if w["mode"] != "train":
        return None
    return w["batch"] * len(w["durations_s"]) / w["window_s"]
