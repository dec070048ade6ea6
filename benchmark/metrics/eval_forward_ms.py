"""Device milliseconds of the forward of a validation pass
(``Trainer._forward_eval``), CUDA events around each, the mean over the
traced window's passes."""


def read(obs):
    ms = obs.get("forward_ms") or []
    return sum(ms) / len(ms) if ms and None not in ms else None
