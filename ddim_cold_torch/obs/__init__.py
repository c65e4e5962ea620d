"""Observability of the port: the step-cached samplers' on-device telemetry
(``device.py``)."""
