"""Requests a device dispatch: ``coalesced_requests / dispatches`` of the
port's ``Dispatcher.stats``, counted over the window."""


def read(obs):
    d = obs.get("dispatches")
    return obs["coalesced_requests"] / d if d else None
