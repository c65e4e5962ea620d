"""Schedules, samplers and the hand-written kernels (``csrc/``)."""
