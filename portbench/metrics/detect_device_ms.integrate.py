"""Device ms of a detection (``models/nbody`` ``_halo_frames`` and
``_apsis_update``): the stretches of the device stream between CUDA
timing events around each detection (``detect_device_s``) over the
detections (``detections``, the seeding one included), in the calls run
without the profiler."""


def read(trace):
    ms = [c["metrics"] for c in trace.plain_calls
          if "detect_device_s" in (c.get("metrics") or {})]
    n = sum(m["detections"] for m in ms)
    return 1e3 * sum(m["detect_device_s"] for m in ms) / n if n else None
