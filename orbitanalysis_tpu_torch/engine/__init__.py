from orbitanalysis_tpu_torch.engine.tracker import track_orbits  # noqa: F401

__all__ = ["track_orbits"]
