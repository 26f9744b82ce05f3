"""Cost analysis of the production dry run: collectives reckoned from
specs and plans, executed op costs of a traced step, and the three-term
roofline (``repro.analysis`` counterpart)."""

from .collectives import CollectiveOp, CollectiveSummary
from .roofline import (H100Constants, RooflineTerms, V5EConstants,
                       model_flops, roofline_from_artifact)

__all__ = ["CollectiveOp", "CollectiveSummary", "H100Constants",
           "RooflineTerms", "V5EConstants", "model_flops",
           "roofline_from_artifact"]
