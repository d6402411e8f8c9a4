"""Serving: the port's artifact (:mod:`point2cyl_torch.serve.export`) and
the bucketed :class:`InferenceSession` (:mod:`point2cyl_torch.serve.session`).

The names are imported on first use, so ``python -m
point2cyl_torch.serve.export`` runs the exporter as a fresh module."""

__all__ = ["export_artifact", "load_artifact", "InferenceSession"]


def __getattr__(name: str):
    if name in ("export_artifact", "load_artifact"):
        from point2cyl_torch.serve import export

        return getattr(export, name)
    if name == "InferenceSession":
        from point2cyl_torch.serve.session import InferenceSession

        return InferenceSession
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
