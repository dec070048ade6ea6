"""A whole validation pass's least time (forward plus ranking) on the
card's published peaks over its measured time, in percent."""

from benchmark.roofline import Work, share_pct


def read(obs):
    whole = obs.get("pass_ms") or []
    if not whole or None in whole:
        return None
    least = (Work(*obs["forward_work"]) + Work(*obs["rank_work"])).least_s()
    return share_pct(least, sum(whole) / len(whole) / 1e3)
