"""The ranking's least time (``roofline.ranking``: scores, masking and
top-k of every validation user) over its measured time a pass, in
percent."""

from benchmark.roofline import Work, share_pct


def read(obs):
    fwd, whole = obs.get("forward_ms") or [], obs.get("pass_ms") or []
    if not whole or len(fwd) != len(whole) or None in whole:
        return None
    rank_s = sum(w - f for w, f in zip(whole, fwd)) / len(whole) / 1e3
    return share_pct(Work(*obs["rank_work"]).least_s(), rank_s)
