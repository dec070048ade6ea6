"""Seconds of the port's graph build: ``build_normalized_adjacency`` and
the construction of the device graph (``Trainer(...)`` or
``Retriever.from_params``), host clock, the card synchronised."""


def read(obs):
    return obs.get("graph_build_s")
