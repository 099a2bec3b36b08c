"""Which backend families a ``--model`` / ``--mock`` choice names.

Decided without importing torch: the CLI asks before it starts the ranks
of a ``--devices N`` run, and the sentiment engine asks when it resolves
its backend.
"""

from __future__ import annotations


def mesh_capable(model: str, mock: bool) -> bool:
    """Whether a sentiment backend family takes a device mesh: the
    on-device models do; the keyword kernel and the Ollama passthrough do
    not (JAX's ``engines/sentiment.py:_mesh_capable``)."""
    return not mock and (
        model.startswith("distilbert") or model.startswith("llama")
    )
