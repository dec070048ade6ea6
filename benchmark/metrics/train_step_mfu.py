"""A training step's least time on the card's published peaks over the
measured time a step (the traced window over its steps), in percent.  The
step's operations and bytes are counted from the cell's shapes
(``roofline.train_step``)."""

from benchmark.roofline import Work, share_pct


def read(obs):
    if not obs.get("steps") or "step_work" not in obs:
        return None
    return share_pct(Work(*obs["step_work"]).least_s(), obs["window_s"] / obs["steps"])
