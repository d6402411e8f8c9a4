"""Serving: the port's artifact (:mod:`point2cyl_torch.serve.export`) and
the bucketed :class:`InferenceSession` (:mod:`point2cyl_torch.serve.session`)."""

from point2cyl_torch.serve.export import export_artifact, load_artifact
from point2cyl_torch.serve.session import InferenceSession

__all__ = ["export_artifact", "load_artifact", "InferenceSession"]
