"""Milliseconds of the ranking of a validation pass (``evaluate_batches``
over every validation user): each pass's CUDA-event time less its
forward's, the mean over the traced window's passes."""


def read(obs):
    fwd, whole = obs.get("forward_ms") or [], obs.get("pass_ms") or []
    if not whole or len(fwd) != len(whole) or None in whole:
        return None
    return sum(w - f for w, f in zip(whole, fwd)) / len(whole)
