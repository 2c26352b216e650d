from orbitanalysis_tpu_torch.models import synthetic  # noqa: F401

__all__ = ["synthetic"]
