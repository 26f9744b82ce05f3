"""Synthetic training data of the port (``repro.data`` counterpart)."""

from .synthetic import MarkovCorpus, TeacherImages

__all__ = ["MarkovCorpus", "TeacherImages"]
