"""Synthetic training data of the port (``repro.data`` counterpart)."""

from .synthetic import MarkovCorpus

__all__ = ["MarkovCorpus"]
