"""Drivers of the traffic mixes, one module a driver, found by the name a
traffic file gives."""
