"""Telemetry of the port: the metrics registry, the flight-recorder
rings, the device seam's metric families and the profiler hooks.
Owned copies of the `spacedrive_tpu/telemetry` modules the port writes
to; the rest of that plane is not ported yet."""
