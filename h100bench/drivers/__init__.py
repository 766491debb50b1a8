"""Drivers: one per traffic ``kind``, found as ``drivers/<kind>.py``. Each
builds the system under test from a configuration, warms it up, runs the
measured window and hands over what the comparison with the reference
needs."""
