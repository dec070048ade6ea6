"""Share of the traced window in which no operation ran on the card: one
minus the union of the device events' intervals in ``torch.profiler``'s
trace over the window's length, in percent."""


def read(obs):
    t = obs.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
