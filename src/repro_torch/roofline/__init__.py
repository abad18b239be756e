"""Roofline analysis of the port's steps (port of ``repro.roofline``)."""
